"""Pooling ops (counterpart of ``dorknet_tpu/ops/pool.py``)."""


def global_avg_pool(x):
    """Spatial mean: (N,H,W,C) -> (N,C)."""
    return x.mean(dim=(1, 2))
