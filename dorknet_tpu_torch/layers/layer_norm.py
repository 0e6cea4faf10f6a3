"""LayerNorm over the channels (the port's own; the JAX package has none):
at every position of an NHWC activation, or over each row of an (N, C)
one, as ConvNeXt normalises. ``gamma`` and ``beta`` are (C,); there are no
running statistics, so train and test mode compute the same function
(``ops/norm.layer_norm``).

h5: ``layer_info`` carries ``channels`` and ``eps``; ``gamma``, ``beta`` and
``grads/gamma``, ``grads/beta`` sit beside it, as a batch norm's do."""

import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.norm import layer_norm
from dorknet_tpu_torch.utils import h5io


@register_layer
class LayerNormLayer(Layer):
    def __init__(self, layer_name, channels=None, eps=1e-6):
        super().__init__(layer_name)
        self.channels = channels
        self.eps = eps
        if channels is not None:
            self.gamma = nn.Parameter(torch.ones(channels))
            self.beta = nn.Parameter(torch.zeros(channels))

    def __repr__(self):
        return "LayerNormLayer({}, channels={}, eps={})".format(
            self.layer_name, self.channels, self.eps)

    def fapply(self, x, train=False):
        return layer_norm(x, self.gamma, self.beta, self.eps)

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "LayerNormLayer",
                               channels=self.channels, eps=self.eps)
        grads = self._grads_to_save()
        for name in ("gamma", "beta"):
            h5io.save_array(open_f, self.layer_name + "/" + name, getattr(self, name))
            if save_grads:
                h5io.save_array(open_f, "{}/grads/{}".format(self.layer_name, name),
                                grads[name])

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.channels = int(info["channels"])
        self.eps = float(info["eps"])

        def read(name):
            return h5io.read_array(open_f, self.layer_name + "/" + name)

        self.gamma = nn.Parameter(torch.from_numpy(read("gamma")))
        self.beta = nn.Parameter(torch.from_numpy(read("beta")))
        if load_grads:
            self.grads = {name: read("grads/" + name) for name in ("gamma", "beta")}
