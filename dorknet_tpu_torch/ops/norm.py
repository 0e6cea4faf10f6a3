"""Batch normalisation (counterpart of ``dorknet_tpu/ops/norm.py``).

The reference keeps the running **std** (sqrt(var + eps)), not the running
variance, so inference divides by the stored std with eps already folded in.
In train mode the first batch adopts the batch statistics and later ones take
an EMA of them at ``momentum`` (0.95); the statistics take no gradient.

The train-mode normalisation is a ``torch.autograd.Function`` with the JAX
package's hand-written backward: one-pass E[x²]−E[x]² statistics (clamped at
0) in the forward, and the two-reduction closed form in the backward,

    dβ = Σ dy ;  dγ = Σ dy·x̂ ;  dx = γ/σ · (dy − dβ/N − x̂·dγ/N)

with x̂ read in x's dtype, as ``_bn_core_fwd`` saves it. The statistics come
from ``batch_norm_stats`` (``ops/cuda/bn_stats.py``), the normalise and the
backward from ``bn_apply``, ``bn_bwd_reduce`` and ``bn_bwd_dx``
(``ops/cuda/bn_train.py``): on the card hand-written kernels that read and
write each activation no more than XLA's fusion of the same formulas does in
the JAX step (7 passes a batch norm after the statistics' read); on the CPU
their plain versions. The forward saves x itself, not x̂: the backward
recomputes x̂ from x with the forward's arithmetic.

``act`` folds the activation that follows the batch norm (``"relu"`` or
``"hswish"``) into the same kernels: the forward returns act(y) and never
writes y, the backward recomputes y from x and differentiates the
activation in registers (``ops/cuda/bn_train.py``). It saves beta besides
(the parameter itself, no copy): no activation-sized tensor more.

``layer_norm`` normalises each position over its channels (the last axis
of an NHWC tensor or of (N, C) rows), ConvNeXt's LayerNorm. The JAX package
has none; it is ``F.layer_norm`` in fp32, the statistics with the biased
variance, and keeps no running statistics. ``layer_norm.launches_by_layout``
counts its calls by input layout (``"nhwc"``, ``"rows"``), bumped in
Python, so a replayed graph leaves it as it is.
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats
from dorknet_tpu_torch.ops.cuda.bn_train import bn_apply, bn_bwd_dx, bn_bwd_reduce


class _BNCore(torch.autograd.Function):
    """Batch-stat normalise over every axis but the last, then ``act``.
    Returns (y, mean, std): y in x's dtype, the statistics in fp32 and not
    differentiable."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act="none"):
        mean, var = batch_norm_stats(x)
        y, norm = bn_apply(x, mean, var, gamma, beta, eps, act)
        # beta only where the backward recomputes y for the activation
        ctx.save_for_backward(x, norm, gamma, *(() if act == "none" else (beta,)))
        ctx.act = act
        std = torch.sqrt(var + eps)
        ctx.mark_non_differentiable(mean, std)
        return y, mean, std

    @staticmethod
    def backward(ctx, gy, _gmean, _gstd):
        x, norm, gamma, *beta = ctx.saved_tensors
        beta = beta[0] if beta else None
        gy = gy.contiguous()
        dgamma, dbeta, coef = bn_bwd_reduce(gy, x, norm, gamma, beta, ctx.act)
        dx = bn_bwd_dx(gy, x, norm, coef, gamma, beta, ctx.act)
        return dx, dgamma, dbeta, None, None


def batch_norm_train(x, gamma, beta, running_mean, running_std, momentum=0.95,
                     eps=1e-5, initialized=True, act="none"):
    """Train-mode BN over a 2-D (N,C) or 4-D (N,H,W,C) input, then ``act``
    (``"none"``, ``"relu"`` or ``"hswish"``) in the same kernels. gamma,
    beta and the running stats are 1-D (C,). Returns (act(y),
    new_running_mean, new_running_std); the new stats carry no gradient.
    ``initialized`` is False on the very first training batch, whose
    statistics are adopted directly (the running stats passed in are then
    not read)."""
    y, mean, std = _BNCore.apply(x, gamma, beta, eps, act)
    if initialized:
        with torch.no_grad():
            new_mean = momentum * running_mean + (1.0 - momentum) * mean
            new_std = momentum * running_std + (1.0 - momentum) * std
        return y, new_mean, new_std
    return y, mean, std


def batch_norm_inference(x, gamma, beta, running_mean, running_std):
    """(x - running_mean) / running_std * gamma + beta, computed in fp32,
    returned in x's dtype. x: (N,H,W,C) or (N,C); the rest (C,)."""
    shape = (1, 1, 1, -1) if x.dim() == 4 else (1, -1)
    x_hat = (x.float() - running_mean.reshape(shape)) / running_std.reshape(shape)
    return (gamma.reshape(shape) * x_hat + beta.reshape(shape)).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-6):
    """(x - mean) / sqrt(var + eps) * gamma + beta over the last axis of an
    (N,H,W,C) or (N,C) x, the statistics and the affine in fp32 (biased
    variance), returned in x's dtype, as batch norm's dtype rules go.
    gamma and beta are the fp32 (C,) parameters."""
    if x.dim() not in (2, 4):
        raise ValueError("layer_norm takes (N,H,W,C) or (N,C), got shape {}".format(
            tuple(x.shape)))
    layer_norm.launches_by_layout["nhwc" if x.dim() == 4 else "rows"] += 1
    return F.layer_norm(x.float(), (x.shape[-1],), gamma, beta, eps).to(x.dtype)


layer_norm.launches_by_layout = {"nhwc": 0, "rows": 0}
