"""The activations as functions of a tensor, in the JAX package's arithmetic
(``dorknet_tpu/layers/activations.py``), shared by the activation layers
and by the batch-norm kernels' plain versions, which apply the activation
that follows a batch norm (``ops/cuda/bn_train.py``).

The clips are written as ``torch.minimum(torch.maximum(...))``, as
``jnp.clip`` computes them, so their gradient at a bound is 0.5, as the JAX
package's (``torch.clamp``'s would be 1)."""

import functools

import torch
import torch.nn.functional as F


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


def hard_sigmoid(x):
    """clip(x + 3, 0, 6) * (1/6) in x's dtype, as the JAX package computes
    it: a multiply by the constant 1/6 (not a division by 6), and in bf16
    the constant rounded to bf16, as JAX's weak-typed Python scalars are."""
    return clip(x + 3.0, 0.0, 6.0) * constant(1.0 / 6.0, x.dtype)


def hard_swish(x):
    """x * hard_sigmoid(x), MobileNet-V3's activation."""
    return x * hard_sigmoid(x)


def gelu(x):
    """x * Phi(x) with the exact erf, in x's dtype: ConvNeXt's GELU (the JAX
    package has none)."""
    return F.gelu(x, approximate="none")


# the activations a batch norm's kernels can apply, by the name they take
BN_ACTIVATIONS = {"none": lambda x: x, "relu": torch.relu, "hswish": hard_swish}
