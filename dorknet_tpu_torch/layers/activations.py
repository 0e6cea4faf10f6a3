"""Activation layers (counterpart of ``dorknet_tpu/layers/activations.py``)."""

import torch

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer


@register_layer
class ReLu(Layer):
    def __repr__(self):
        return "ReLu({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return torch.relu(x)

    def load_from_h5(self, open_f):
        pass


@register_layer
class IdentityLayer(Layer):
    """Pass-through: lets ResidualBlock model a linear join."""

    def __repr__(self):
        return "IdentityLayer({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return x

    def load_from_h5(self, open_f):
        pass
