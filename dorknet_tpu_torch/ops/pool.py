"""Pooling ops (counterpart of ``dorknet_tpu/ops/pool.py``)."""

import torch.nn.functional as F


def max_pool(x, stride, window=None, padding=0):
    """Max pool over NHWC x: (N,H,W,C) -> (N,P,Q,C), NHWC-contiguous. With
    the defaults the window equals the stride and nothing is padded, the JAX
    package's pool (VALID: a ragged edge is dropped). ``window`` and
    ``padding`` give an overlapping, padded pool (the canonical ResNet stem's
    3x3/s2 with padding 1: P = (H + 2 * padding - window) // stride + 1, the
    padding never the maximum). The gradient goes to each window's maximum;
    on tied maxima it may pick another element than the JAX package's
    ``reduce_window`` does."""
    window = stride if window is None else window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=window, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x):
    """Spatial mean: (N,H,W,C) -> (N,C)."""
    return x.mean(dim=(1, 2))
