"""A test-mode layer's bias add and the activation after it in one pass:
``bias_act(y, b, act)`` -> act(y + b) of y (..., C) and b (C,).

The hand-written CUDA kernel ``bias_act_kernel`` (``csrc/bn_train.cu``,
``bn_apply``'s pointwise loop with y + b where it normalises) reads y and
writes the result once. As eager PyTorch ops the broadcast bias add took 2
activation passes, a ReLU 2 more and a hard-swish 11 more. In a test-mode
forward without a gradient, the conv and dense ops (``ops/conv.py``) call it
for every biased layer, with the ReLU or hard-swish after it that
``layers/sequence.run_layers`` hands over: after ``fold_bn`` that is every
conv of a served network.

The bias is added in fp32 and rounded to y's dtype, and the activation
(``act``: ``"none"``, ``"relu"`` or ``"hswish"``) runs in that dtype as the
activation layers compute it (``ops/activation.BN_ACTIVATIONS``): the result
is bit-equal to ``bias_add`` followed by the activation layer, in fp32 and
in bf16.

``bias_act`` is the registered op ``dorknet::bias_act`` (with a fake), so
``torch.export`` records it and an exported serving program runs the kernel.
On a CPU tensor it computes the same function with its plain version
(``bias_act_plain``). It has no gradient: a caller that needs one runs
``bias_add`` and the activation under autograd. The kernel's launches are
counted in ``bias_act.launches``, and by activation in
``bias_act.launches_by_act``.
"""

import torch

from dorknet_tpu_torch.ops.activation import BN_ACTIVATIONS
from dorknet_tpu_torch.ops.cuda.bn_stats import sm_count
from dorknet_tpu_torch.ops.cuda.bn_train import (ACT_CODE, _check_act_name, _launch_args,
                                                 _on_card, pointwise_threads, vector_width)
from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library


def bias_add(y, b):
    """y + b over y's last axis: the add in fp32, the result in y's dtype."""
    b = b.reshape((1,) * (y.dim() - 1) + (-1,))
    if y.dtype == torch.float32:
        return y + b
    return (y.float() + b).to(y.dtype)


def bias_act_plain(y, b, act="none"):
    return BN_ACTIVATIONS[act](bias_add(y, b))


def _launch(y, b, act):
    """The kernel on CUDA tensors: y contiguous, b contiguous (C,)."""
    if not (y.is_contiguous() and b.is_contiguous()):
        raise ValueError("bias_act: y and b must be contiguous")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    C = y.shape[-1]
    M = y.numel() // C
    V = vector_width(C, y.dtype, y, out)
    G = pointwise_threads(M, C, V, sm_count(y.device.index))
    kernels = load_library()
    err = kernels.lib.dorknet_bias_act(y.data_ptr(), b.data_ptr(), out.data_ptr(), M, C,
                                       int(V > 1), ACT_CODE[act], G, *_launch_args(y))
    check(kernels.lib, err, "bias_act launch")
    bias_act.launches += 1
    bias_act.launches_by_act[act] += 1
    return out


@torch.library.custom_op("dorknet::bias_act", mutates_args=())
def bias_act_op(y: torch.Tensor, b: torch.Tensor, act: str) -> torch.Tensor:
    """``bias_act`` as the registered op ``dorknet::bias_act``: the plain
    version on a CPU tensor, the kernel on a CUDA one. The vector width and
    the grid are read here, at run time, so a program exported with a
    symbolic batch still takes the vector route."""
    if _on_card("bias_act", y):
        return _launch(y, b, act)
    return bias_act_plain(y, b, act)


@bias_act_op.register_fake
def _bias_act_fake(y, b, act):
    return torch.empty_like(y)


def bias_act(y, b, act="none"):
    """y: (..., C) float32 or bfloat16, contiguous on the card; b: float32
    (C,) on y's device; act: "none", "relu" or "hswish". Returns act(y + b)
    in y's dtype. Raises where a gradient is needed: it has none."""
    _check_act_name("bias_act", act)
    if y.dtype not in DTYPE_CODE or y.dim() < 1:
        raise TypeError("bias_act: y must be (..., C) float32 or bfloat16, got {} {}".format(
            y.dtype, tuple(y.shape)))
    if tuple(b.shape) != (y.shape[-1],) or b.dtype != torch.float32 or b.device != y.device:
        raise ValueError("bias_act: b must be float32 of shape ({},) on {}, got {} {} on "
                         "{}".format(y.shape[-1], y.device, b.dtype, tuple(b.shape), b.device))
    if torch.is_grad_enabled() and (y.requires_grad or b.requires_grad):
        raise RuntimeError("bias_act has no gradient: run bias_add and the activation where "
                           "one is needed")
    return bias_act_op(y, b, act)


bias_act.launches = 0
bias_act.launches_by_act = dict.fromkeys(ACT_CODE, 0)
