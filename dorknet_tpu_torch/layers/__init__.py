"""Layers of the port (counterpart of ``dorknet_tpu.layers``); importing
this package fills the layer registry."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.convolution import ConvLayer
from dorknet_tpu_torch.layers.depthwise_convolution import DepthwiseConvLayer
from dorknet_tpu_torch.layers.pointwise_convolution import PointwiseConvLayer
from dorknet_tpu_torch.layers.dense_layer import DenseLayer
from dorknet_tpu_torch.layers.batch_norm import BatchNormLayer
from dorknet_tpu_torch.layers.activations import (GELU, HardSigmoid, HardSwish, IdentityLayer,
                                                  ReLu, ReLu6)
from dorknet_tpu_torch.layers.layer_norm import LayerNormLayer
from dorknet_tpu_torch.layers.layer_scale import LayerScale
from dorknet_tpu_torch.layers.squeeze_excite import SqueezeExciteLayer
from dorknet_tpu_torch.layers.pooling import GlobalAveragePoolingLayer, MaxPoolLayer
from dorknet_tpu_torch.layers.reshape import ReshapeLayer
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
    "ReLu6",
    "IdentityLayer",
    "HardSwish",
    "HardSigmoid",
    "GELU",
    "LayerNormLayer",
    "LayerScale",
    "SqueezeExciteLayer",
    "GlobalAveragePoolingLayer",
    "MaxPoolLayer",
    "ReshapeLayer",
    "ResidualBlock",
    "SoftmaxWithCrossEntropy",
]
