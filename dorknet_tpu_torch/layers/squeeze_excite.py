"""Squeeze-and-excitation layer (counterpart of
``dorknet_tpu/layers/squeeze_excite.py``), MobileNet-V3's channel gate:

    s = mean(x, spatial)                      # (N, C), in fp32
    h = relu(s @ w_reduce + b_reduce)         # (N, Cr)
    g = hardsigmoid(h @ w_expand + b_expand)  # (N, C), in fp32
    y = x * g[:, None, None, :]               # g cast to x's dtype

The two FCs are the port's ``ops.conv.dense``, so they take the compute
dtype as every dense layer does. The four parameters come in the JAX
dict's order, so ``gather_params()`` trees line up. The regulariser covers
both FC weights; the h5 schema attaches its attrs to ``w_reduce`` only and
reads them back from there, as the JAX package does.
"""

import numpy as np
import torch
from torch import nn

from dorknet_tpu_torch.layers.activations import hard_sigmoid
from dorknet_tpu_torch.layers.base import Layer, init_weights
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.conv import dense
from dorknet_tpu_torch.utils import h5io

_PARAM_KEYS = ("w_reduce", "b_reduce", "w_expand", "b_expand")


@register_layer
class SqueezeExciteLayer(Layer):
    def __init__(self, layer_name, incoming_chans=None, reduced_chans=None,
                 weight_regulariser=None, weight_initialiser="glorot_uniform"):
        super().__init__(layer_name)
        self.incoming_chans = incoming_chans
        self.reduced_chans = reduced_chans
        self.weight_regulariser = weight_regulariser
        self.weight_initialiser = weight_initialiser
        if incoming_chans is not None:
            if reduced_chans is None:
                self.reduced_chans = max(8, incoming_chans // 4)
            C, Cr = incoming_chans, self.reduced_chans
            # drawn in the JAX package's order: w_reduce, then w_expand
            self.w_reduce = nn.Parameter(init_weights((C, Cr), weight_initialiser, C, Cr))
            self.b_reduce = nn.Parameter(torch.zeros(Cr))
            self.w_expand = nn.Parameter(init_weights((Cr, C), weight_initialiser, Cr, C))
            self.b_expand = nn.Parameter(torch.zeros(C))

    def __repr__(self):
        return ("SqueezeExciteLayer({}, incoming_chans={}, reduced_chans={}, "
                "weight_regulariser={})".format(
                    self.layer_name, self.incoming_chans, self.reduced_chans,
                    repr(self.weight_regulariser)))

    def fapply(self, x, train=False):
        s = x.float().mean(dim=(1, 2))
        h = torch.relu(dense(s, self.w_reduce, self.b_reduce))
        g = hard_sigmoid(dense(h, self.w_expand, self.b_expand).float())
        return x * g[:, None, None, :].to(x.dtype)

    def reg_loss(self):
        if self.weight_regulariser is not None and self.incoming_chans is not None:
            return (self.weight_regulariser.forward(self.w_reduce)
                    + self.weight_regulariser.forward(self.w_expand))
        return 0.0

    def save_to_h5(self, open_f, save_grads=True):
        h5io.create_layer_info(open_f, self.layer_name, "SqueezeExciteLayer",
                               incoming_chans=self.incoming_chans,
                               reduced_chans=self.reduced_chans)
        grads = self._grads_to_save()
        for k in _PARAM_KEYS:
            d = h5io.save_array(open_f, self.layer_name + "/" + k, getattr(self, k))
            if k == "w_reduce":
                h5io.attach_regulariser_attrs(d, self.weight_regulariser)
            if save_grads:
                h5io.save_array(open_f, self.layer_name + "/grads/" + k, grads[k])

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.incoming_chans = int(info["incoming_chans"])
        self.reduced_chans = int(info["reduced_chans"])
        grads = {}
        for k in _PARAM_KEYS:
            setattr(self, k, nn.Parameter(torch.from_numpy(
                np.asarray(open_f[self.layer_name + "/" + k][:], dtype=np.float32))))
            if load_grads:
                grads[k] = np.asarray(open_f[self.layer_name + "/grads/" + k][:],
                                      dtype=np.float32)
        if load_grads:
            self.grads = grads
        self.weight_regulariser = h5io.load_regulariser(open_f[self.layer_name + "/w_reduce"])
