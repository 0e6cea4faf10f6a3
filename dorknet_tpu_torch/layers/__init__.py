"""Layers of the port (counterpart of ``dorknet_tpu.layers``); importing
this package fills the layer registry."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.convolution import ConvLayer
from dorknet_tpu_torch.layers.depthwise_convolution import DepthwiseConvLayer
from dorknet_tpu_torch.layers.pointwise_convolution import PointwiseConvLayer
from dorknet_tpu_torch.layers.dense_layer import DenseLayer
from dorknet_tpu_torch.layers.batch_norm import BatchNormLayer
from dorknet_tpu_torch.layers.activations import ReLu, IdentityLayer
from dorknet_tpu_torch.layers.pooling import GlobalAveragePoolingLayer
from dorknet_tpu_torch.layers.residual_block import ResidualBlock
from dorknet_tpu_torch.layers.losses import SoftmaxWithCrossEntropy

__all__ = [
    "Layer",
    "ConvLayer",
    "DepthwiseConvLayer",
    "PointwiseConvLayer",
    "DenseLayer",
    "BatchNormLayer",
    "ReLu",
    "IdentityLayer",
    "GlobalAveragePoolingLayer",
    "ResidualBlock",
    "SoftmaxWithCrossEntropy",
]
