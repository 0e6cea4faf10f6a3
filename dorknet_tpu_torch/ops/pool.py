"""Pooling ops (counterpart of ``dorknet_tpu/ops/pool.py``)."""

import torch.nn.functional as F


def max_pool(x, stride):
    """Non-overlapping max pool, window = stride, VALID (a ragged edge is
    dropped). x: (N,H,W,C) -> (N,H//stride,W//stride,C), NHWC-contiguous.
    The gradient goes to each window's maximum; on tied maxima it may pick
    another element than the JAX package's ``reduce_window`` does."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=stride, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x):
    """Spatial mean: (N,H,W,C) -> (N,C)."""
    return x.mean(dim=(1, 2))
