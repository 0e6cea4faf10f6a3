"""Activation layers (counterpart of ``dorknet_tpu/layers/activations.py``)."""

import torch

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.utils import h5io


@register_layer
class ReLu(Layer):
    def __repr__(self):
        return "ReLu({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return torch.relu(x)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "ReLu")

    def load_from_h5(self, open_f, load_grads=True):
        pass


@register_layer
class ReLu6(Layer):
    """min(max(x, 0), 6), MobileNet-V2's activation (not in the reference).
    Written as ``jnp.clip`` computes it, so its gradient at exactly 0 or 6
    is 0.5, as the JAX package's (``torch.clamp``'s would be 1)."""

    def __repr__(self):
        return "ReLu6({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "ReLu6")

    def load_from_h5(self, open_f, load_grads=True):
        pass


@register_layer
class IdentityLayer(Layer):
    """Pass-through: lets ResidualBlock model a linear join."""

    def __repr__(self):
        return "IdentityLayer({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return x

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "IdentityLayer")

    def load_from_h5(self, open_f, load_grads=True):
        pass
