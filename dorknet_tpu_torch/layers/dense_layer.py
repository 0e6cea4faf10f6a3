"""Dense (fully-connected) layer (counterpart of
``dorknet_tpu/layers/dense_layer.py``): weights (incoming_chans, output_dim),
X @ W + b, the reference's repr and h5 schema."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer, init_weights
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.conv import dense
from dorknet_tpu_torch.utils import h5io


@register_layer
class DenseLayer(Layer):
    def __init__(self, layer_name, incoming_chans=None, output_dim=None, with_bias=True,
                 weight_regulariser=None, weight_initialiser="normal"):
        super().__init__(layer_name)
        self.incoming_chans = incoming_chans
        self.output_dim = output_dim
        self.with_bias = with_bias
        self.weight_regulariser = weight_regulariser
        self.weight_initialiser = weight_initialiser
        if incoming_chans is not None and output_dim is not None:
            self.weights = nn.Parameter(init_weights(
                (incoming_chans, output_dim), weight_initialiser,
                incoming_chans, output_dim))
            if with_bias:
                self.bias = nn.Parameter(torch.zeros(output_dim))

    def __repr__(self):
        return "DenseLayer({}, incoming_chans={}, output_dim={}, weight_regulariser={})".format(
            self.layer_name, self.incoming_chans, self.output_dim,
            repr(self.weight_regulariser))

    def fapply(self, x, train=False, act=None):
        """``act`` ("none", "relu" or "hswish", with a bias) adds the bias and
        applies the activation that follows in one pass where no gradient is
        needed (``layers/sequence.py`` passes it in test mode)."""
        b = self.bias if self.with_bias else None
        return dense(x, self.weights, b, act=act)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(
            open_f, self.layer_name, "DenseLayer",
            incoming_chans=self.incoming_chans, output_dim=self.output_dim,
            with_bias=self.with_bias)
        self._save_weights_to_h5(open_f, save_grads)

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.incoming_chans = int(info["incoming_chans"])
        self.output_dim = int(info["output_dim"])
        self.with_bias = bool(info["with_bias"])
        self._load_weights_from_h5(open_f, load_grads)
