"""Batch normalisation, test mode (counterpart of ``dorknet_tpu/ops/norm.py``).

The reference keeps the running **std** (sqrt(var + eps)), not the running
variance, so inference divides by the stored std with eps already folded in.
Train mode comes with the training slice.
"""


def batch_norm_inference(x, gamma, beta, running_mean, running_std):
    """(x - running_mean) / running_std * gamma + beta, computed in fp32,
    returned in x's dtype. x: (N,H,W,C) or (N,C); the rest (C,)."""
    shape = (1, 1, 1, -1) if x.dim() == 4 else (1, -1)
    x_hat = (x.float() - running_mean.reshape(shape)) / running_std.reshape(shape)
    return (gamma.reshape(shape) * x_hat + beta.reshape(shape)).to(x.dtype)
