"""Standard convolution layer (counterpart of ``dorknet_tpu/layers/convolution.py``):
weights (num_filters, filter_chans, f_rows, f_cols), optional bias, zero
padding, square stride, the reference's repr and h5 schema."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer, init_weights
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.conv import conv2d


@register_layer
class ConvLayer(Layer):
    def __init__(self, layer_name, filter_block_shape=None, stride=1, padding=1,
                 with_bias=True, weight_regulariser=None, weight_initialiser="normal"):
        super().__init__(layer_name)
        self.stride = stride
        self.padding = padding
        self.with_bias = with_bias
        self.weight_regulariser = weight_regulariser
        self.weight_initialiser = weight_initialiser
        self.num_filters = None
        if filter_block_shape:
            (self.num_filters, self.filter_chans,
             self.f_rows, self.f_cols) = filter_block_shape
            self.weights = nn.Parameter(init_weights(
                filter_block_shape, weight_initialiser,
                self.filter_chans, self.num_filters))
            if with_bias:
                self.bias = nn.Parameter(torch.zeros(self.num_filters))

    def __repr__(self):
        out = "ConvLayer({}, ".format(self.layer_name)
        if self.num_filters is not None:
            # the reference prints f_rows twice; kept verbatim so
            # structure-json files are byte-compatible
            out += "filter_block_shape=({},{},{},{}), ".format(
                self.num_filters, self.filter_chans, self.f_rows, self.f_rows)
        out += "stride={}, padding={}, with_bias={}, weight_regulariser={})".format(
            self.stride, self.padding, self.with_bias, self.weight_regulariser)
        return out

    def fapply(self, x, train=False):
        b = self.bias if self.with_bias else None
        return conv2d(x, self.weights, b, stride=self.stride, padding=self.padding)

    def load_from_h5(self, open_f):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.num_filters = int(info["num_filters"])
        self.filter_chans = int(info["filter_chans"])
        self.with_bias = bool(info["with_bias"])
        self.f_rows = int(info["f_rows"])
        self.f_cols = int(info["f_cols"])
        self.stride = int(info["stride"])
        self.padding = int(info["padding"])
        self._load_weights_from_h5(open_f)
