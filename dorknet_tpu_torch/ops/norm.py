"""Batch normalisation (counterpart of ``dorknet_tpu/ops/norm.py``).

The reference keeps the running **std** (sqrt(var + eps)), not the running
variance, so inference divides by the stored std with eps already folded in.
In train mode the first batch adopts the batch statistics and later ones take
an EMA of them at ``momentum`` (0.95); the statistics take no gradient.

The train-mode normalisation is a ``torch.autograd.Function`` with the JAX
package's hand-written backward: one-pass E[x²]−E[x]² statistics (clamped at
0) in the forward, and the two-reduction closed form in the backward,

    dβ = Σ dy ;  dγ = Σ dy·x̂ ;  dx = γ/σ · (dy − dβ/N − x̂·dγ/N)

with x̂ saved in x's dtype, as ``_bn_core_fwd`` saves it.
"""

import torch


def _reduce_dims(x):
    return tuple(range(x.dim() - 1))


class _BNCore(torch.autograd.Function):
    """Batch-stat normalise over every axis but the last. Returns (y, mean,
    std): y in x's dtype, the statistics in fp32 and not differentiable."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        dims = _reduce_dims(x)
        xf = x.float()
        mean = xf.mean(dim=dims)
        var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        x_hat = (xf - mean) * inv
        y = (gamma * x_hat + beta).to(x.dtype)
        std = torch.sqrt(var + eps)
        ctx.save_for_backward(x_hat.to(x.dtype), inv, gamma)
        ctx.mark_non_differentiable(mean, std)
        return y, mean, std

    @staticmethod
    def backward(ctx, gy, _gmean, _gstd):
        x_hat, inv, gamma = ctx.saved_tensors
        dims = _reduce_dims(gy)
        n = gy.numel() // gy.shape[-1]
        gyf = gy.float()
        x_hat = x_hat.float()
        dbeta = gyf.sum(dim=dims)
        dgamma = (gyf * x_hat).sum(dim=dims)
        dx = (gamma * inv) * (gyf - dbeta / n - x_hat * (dgamma / n))
        return dx.to(gy.dtype), dgamma, dbeta, None


def batch_norm_train(x, gamma, beta, running_mean, running_std, momentum=0.95,
                     eps=1e-5, initialized=True):
    """Train-mode BN over a 2-D (N,C) or 4-D (N,H,W,C) input. gamma, beta and
    the running stats are 1-D (C,). Returns (y, new_running_mean,
    new_running_std); the new stats carry no gradient. ``initialized`` is
    False on the very first training batch, whose statistics are adopted
    directly (the running stats passed in are then not read)."""
    y, mean, std = _BNCore.apply(x, gamma, beta, eps)
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
