"""Reshape layer (counterpart of ``dorknet_tpu/layers/reshape.py``): a
reshape over the public NCHW layout that keeps the batch dimension."""

from dorknet_tpu_torch.layers.base import Layer, to_nchw, to_nhwc
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.utils import h5io


@register_layer
class ReshapeLayer(Layer):
    def __init__(self, layer_name, new_shape=None):
        super().__init__(layer_name)
        self.new_shape = tuple(new_shape) if new_shape is not None else None

    def __repr__(self):
        return "ReshapeLayer({}, new_shape={})".format(self.layer_name, self.new_shape)

    def fapply(self, x, train=False):
        # NCHW in, the batch kept, back to NHWC when the result is 4-D
        x = to_nchw(x)
        return to_nhwc(x.reshape((x.shape[0],) + self.new_shape))

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "ReshapeLayer",
                               new_shape=list(self.new_shape))

    def load_from_h5(self, open_f, load_grads=True):
        self.new_shape = tuple(
            int(v) for v in open_f[self.layer_name + "/layer_info"].attrs["new_shape"])
