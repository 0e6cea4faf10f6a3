"""Activation layers (counterpart of ``dorknet_tpu/layers/activations.py``).

The clips are written as ``torch.minimum(torch.maximum(...))``, as
``jnp.clip`` computes them, so their gradient at a bound is 0.5, as the JAX
package's (``torch.clamp``'s would be 1)."""

import functools

import torch

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.utils import h5io


@functools.cache
def constant(value, dtype):
    """``value`` as a 0-dim CPU tensor of ``dtype``: a binary op takes it as
    a scalar on any device, with no launch or allocation there (and a
    captured graph keeps it as a kernel argument). Made outside inference
    mode, so autograd may save it whatever mode first asked for it."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype)


def clip(x, lo, hi):
    """min(max(x, lo), hi), as ``jnp.clip``: the gradient at a bound is 0.5."""
    return torch.minimum(torch.maximum(x, constant(lo, x.dtype)), constant(hi, x.dtype))


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
    """min(max(x, 0), 6), MobileNet-V2's activation (not in the reference)."""

    def __repr__(self):
        return "ReLu6({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return clip(x, 0.0, 6.0)

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


def hard_sigmoid(x):
    """clip(x + 3, 0, 6) * (1/6) in x's dtype, as the JAX package computes
    it: a multiply by the constant 1/6 (not a division by 6), and in bf16
    the constant rounded to bf16, as JAX's weak-typed Python scalars are."""
    return clip(x + 3.0, 0.0, 6.0) * constant(1.0 / 6.0, x.dtype)


@register_layer
class HardSwish(Layer):
    """x * relu6(x + 3) / 6, MobileNet-V3's activation (not in the
    reference)."""

    def __repr__(self):
        return "HardSwish({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return x * hard_sigmoid(x)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "HardSwish")

    def load_from_h5(self, open_f, load_grads=True):
        pass


@register_layer
class HardSigmoid(Layer):
    """relu6(x + 3) / 6, the gate of MobileNet-V3's squeeze-excite blocks."""

    def __repr__(self):
        return "HardSigmoid({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return hard_sigmoid(x)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "HardSigmoid")

    def load_from_h5(self, open_f, load_grads=True):
        pass
