"""Depthwise convolution layer (counterpart of
``dorknet_tpu/layers/depthwise_convolution.py``): weights
(num_incoming_channels, f_rows, f_cols), the reference's stride/padding/bias
semantics, repr and h5 schema. The 3x3 stride-1/2 cases run the hand-written
CUDA kernels on a GPU; a 7x7 / padding 3 / stride 1 layer with C a multiple
of 4 runs cuDNN's forward and dx and, in training, the hand-written weight
gradient; every other shape runs ``F.conv2d`` (``ops/conv.py:depthwise_conv2d``)."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer, init_weights
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.conv import depthwise_conv2d
from dorknet_tpu_torch.utils import h5io


@register_layer
class DepthwiseConvLayer(Layer):
    def __init__(self, layer_name, filter_block_shape=None,
                 stride=1, padding=1, with_bias=True,
                 weight_regulariser=None, weight_initialiser="normal"):
        """filter_block_shape = (num_incoming_channels, num_filter_rows, num_filter_cols)"""
        super().__init__(layer_name)
        self.stride = stride
        self.padding = padding
        self.with_bias = with_bias
        self.weight_regulariser = weight_regulariser
        self.weight_initialiser = weight_initialiser
        self.num_filters = None
        if filter_block_shape is not None:
            self.num_filters, self.f_rows, self.f_cols = filter_block_shape
            self.weights = nn.Parameter(init_weights(
                filter_block_shape, weight_initialiser,
                self.num_filters, self.num_filters))
            if with_bias:
                self.bias = nn.Parameter(torch.zeros(self.num_filters))

    def __repr__(self):
        out = "DepthwiseConvLayer({}, ".format(self.layer_name)
        if self.num_filters is not None:
            out += "filter_block_shape=({}, {}, {}), ".format(
                self.num_filters, self.f_rows, self.f_cols)
        out += "stride={}, padding={}, with_bias={}, weight_regulariser={})".format(
            self.stride, self.padding, self.with_bias, repr(self.weight_regulariser))
        return out

    def fapply(self, x, train=False, act=None):
        """``act`` ("none", "relu" or "hswish", with a bias) adds the bias and
        applies the activation that follows in one pass where no gradient is
        needed (``layers/sequence.py`` passes it in test mode)."""
        b = self.bias if self.with_bias else None
        return depthwise_conv2d(x, self.weights, b,
                                stride=self.stride, padding=self.padding, act=act)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(
            open_f, self.layer_name, "DepthwiseConvLayer",
            with_bias=self.with_bias, num_filters=self.num_filters,
            f_rows=self.f_rows, f_cols=self.f_cols,
            stride=self.stride, padding=self.padding)
        self._save_weights_to_h5(open_f, save_grads)

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.num_filters = int(info["num_filters"])
        self.with_bias = bool(info["with_bias"])
        self.f_rows = int(info["f_rows"])
        self.f_cols = int(info["f_cols"])
        self.stride = int(info["stride"])
        self.padding = int(info["padding"])
        self._load_weights_from_h5(open_f, load_grads)
