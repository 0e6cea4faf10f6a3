"""Activation layers (counterpart of ``dorknet_tpu/layers/activations.py``).

The functions they apply are ``ops/activation.py``'s: the clips are written
as ``torch.minimum(torch.maximum(...))``, as ``jnp.clip`` computes them, so
their gradient at a bound is 0.5, as the JAX package's (``torch.clamp``'s
would be 1). In a train-mode layer list, a ``ReLu`` or ``HardSwish`` right
after a ``BatchNormLayer`` runs inside the batch norm's kernels
(``layers/sequence.py``); its ``fapply`` is then not called. ``GELU`` (the
exact erf, ConvNeXt's) is the port's own and is never paired."""

import torch

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.activation import (  # noqa: F401 (constant: its cache)
    clip, constant, gelu, hard_sigmoid, hard_swish)
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


@register_layer
class HardSwish(Layer):
    """x * relu6(x + 3) / 6, MobileNet-V3's activation (not in the
    reference)."""

    def __repr__(self):
        return "HardSwish({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return hard_swish(x)

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


@register_layer
class GELU(Layer):
    """x * Phi(x) with the exact erf (``ops/activation.gelu``), ConvNeXt's
    activation (not in the reference)."""

    def __repr__(self):
        return "GELU({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return gelu(x)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "GELU")

    def load_from_h5(self, open_f, load_grads=True):
        pass
