"""A learned per-channel multiply, ConvNeXt's layer scale (the port's own;
the JAX package has none): y = x * scale over the last axis, ``scale`` (C,)
cast to x's dtype. A fresh layer starts at 1e-6, as ConvNeXt does.

h5: ``layer_info`` carries ``channels``; ``scale`` and ``grads/scale`` sit
beside it."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.utils import h5io


INIT = 1e-6  # ConvNeXt's layer_scale_init_value


@register_layer
class LayerScale(Layer):
    def __init__(self, layer_name, channels=None):
        super().__init__(layer_name)
        self.channels = channels
        if channels is not None:
            self.scale = nn.Parameter(torch.full((channels,), INIT))

    def __repr__(self):
        return "LayerScale({}, channels={})".format(self.layer_name, self.channels)

    def fapply(self, x, train=False):
        return x * self.scale.to(x.dtype)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "LayerScale", channels=self.channels)
        h5io.save_array(open_f, self.layer_name + "/scale", self.scale)
        if save_grads:
            h5io.save_array(open_f, self.layer_name + "/grads/scale",
                            self._grads_to_save()["scale"])

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.channels = int(info["channels"])
        self.scale = nn.Parameter(torch.from_numpy(
            h5io.read_array(open_f, self.layer_name + "/scale")))
        if load_grads:
            self.grads = {"scale": h5io.read_array(open_f, self.layer_name + "/grads/scale")}
