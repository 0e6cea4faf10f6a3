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
    def __init__(self, layer_name, input_shape=None, stride=2, window=None, padding=0):
        """Square regions; ``input_shape`` is accepted and unused, as in the
        reference. By default the window equals the stride and nothing is
        padded (the reference's and the JAX package's only pool); ``window``
        and ``padding`` give an overlapping, padded pool, such as the
        canonical ResNet stem's 3x3/s2 with padding 1. Only such a pool
        writes ``window`` and ``padding`` into its h5 attrs, so a default
        pool's file stays the reference's; a file without them loads as
        window = stride, padding 0."""
        super().__init__(layer_name)
        self.stride = stride
        self.window = stride if window is None else window
        self.padding = padding

    def _default(self):
        return self.window == self.stride and self.padding == 0

    def __repr__(self):
        if self._default():
            return "MaxPoolLayer(stride={})".format(self.stride)
        return "MaxPoolLayer(stride={}, window={}, padding={})".format(
            self.stride, self.window, self.padding)

    def fapply(self, x, train=False):
        return max_pool(x, self.stride, self.window, self.padding)

    def save_to_h5(self, open_f, save_grads=True):
        extra = {} if self._default() else dict(window=self.window, padding=self.padding)
        h5io.create_layer_info(open_f, self.layer_name, "MaxPoolLayer", stride=self.stride,
                               **extra)

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.stride = int(info["stride"])
        self.window = int(info.get("window", self.stride))
        self.padding = int(info.get("padding", 0))
