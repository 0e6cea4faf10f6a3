"""Pooling layers (counterpart of ``dorknet_tpu/layers/pooling.py``)."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.pool import global_avg_pool


@register_layer
class GlobalAveragePoolingLayer(Layer):
    """Mean over spatial dims: (N,C,H,W) -> (N,C)."""

    def __repr__(self):
        return "GlobalAveragePoolingLayer({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return global_avg_pool(x)

    def load_from_h5(self, open_f):
        pass
