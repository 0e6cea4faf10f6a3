"""Pooling layers (counterpart of ``dorknet_tpu/layers/pooling.py``)."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.pool import global_avg_pool, max_pool
from dorknet_tpu_torch.utils import h5io


@register_layer
class GlobalAveragePoolingLayer(Layer):
    """Mean over spatial dims: (N,C,H,W) -> (N,C)."""

    def __repr__(self):
        return "GlobalAveragePoolingLayer({})".format(self.layer_name)

    def fapply(self, x, train=False):
        return global_avg_pool(x)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "GlobalAveragePoolingLayer")

    def load_from_h5(self, open_f, load_grads=True):
        pass


@register_layer
class MaxPoolLayer(Layer):
    def __init__(self, layer_name, input_shape=None, stride=2):
        """Square, non-overlapping regions only (window size == stride);
        ``input_shape`` is accepted and unused, as in the reference."""
        super().__init__(layer_name)
        self.stride = stride

    def __repr__(self):
        return "MaxPoolLayer(stride={})".format(self.stride)

    def fapply(self, x, train=False):
        return max_pool(x, self.stride)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "MaxPoolLayer", stride=self.stride)

    def load_from_h5(self, open_f, load_grads=True):
        self.stride = int(open_f[self.layer_name + "/layer_info"].attrs["stride"])
