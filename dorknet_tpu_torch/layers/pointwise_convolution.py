"""Pointwise (1x1) convolution layer (counterpart of
``dorknet_tpu/layers/pointwise_convolution.py``): weights (num_filters,
num_incoming_channels); stride > 1 subsamples the input grid before the GEMM
(output spatial size ceil(H/s)); the reference's repr and h5 schema,
including the fallback to stride 1 when the attr is absent."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer, init_weights
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.conv import pointwise_conv2d


@register_layer
class PointwiseConvLayer(Layer):
    def __init__(self, layer_name, stride=1, filter_block_shape=None, with_bias=True,
                 weight_regulariser=None, weight_initialiser="normal"):
        """filter_block_shape = (num_filters, num_incoming_channels)"""
        super().__init__(layer_name)
        self.stride = stride
        self.with_bias = with_bias
        self.weight_regulariser = weight_regulariser
        self.weight_initialiser = weight_initialiser
        self.num_filters = None
        if filter_block_shape is not None:
            self.num_filters, self.num_channels = filter_block_shape
            self.weights = nn.Parameter(init_weights(
                filter_block_shape, weight_initialiser,
                self.num_channels, self.num_filters))
            if with_bias:
                self.bias = nn.Parameter(torch.zeros(self.num_filters))

    def __repr__(self):
        out = "PointwiseConvLayer({}, ".format(self.layer_name)
        if self.num_filters is not None:
            out += "filter_block_shape=({}, {}), ".format(self.num_filters,
                                                          self.num_channels)
        # is_on_gpu is always False in the port: it is printed only so that
        # structure-json files stay byte-compatible with the reference's
        out += "stride={}, with_bias={}, weight_regulariser={}, is_on_gpu=False)".format(
            self.stride, self.with_bias, repr(self.weight_regulariser))
        return out

    def fapply(self, x, train=False):
        b = self.bias if self.with_bias else None
        return pointwise_conv2d(x, self.weights, b, stride=self.stride)

    def load_from_h5(self, open_f):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.num_filters = int(info["num_filters"])
        self.num_channels = int(info["num_channels"])
        stride = info.get("stride", None)
        self.stride = int(stride) if stride else 1
        self.with_bias = bool(info["with_bias"])
        self._load_weights_from_h5(open_f)
