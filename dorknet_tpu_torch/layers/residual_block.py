"""Residual block (counterpart of ``dorknet_tpu/layers/residual_block.py``):
``layer_list`` runs in sequence, ``skip_projection`` (or identity) bridges
the input, the two join by addition and ``post_skip_activation`` follows.
Parameter, state and gradient trees are ``{"layers": [...], "skip": {...},
"act": {...}}``, as in the JAX package; the h5 schema (flat-namespace
children plus attr-encoded structure) is the reference's.

One reference quirk is kept on purpose: the reported regularisation
(``reg_loss``) sums over ``layer_list`` only, while the applied gradient
also carries the skip projection's term (``reg_loss_full``)."""

from torch import nn

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import get_layer_class, register_layer
from dorknet_tpu_torch.utils import h5io


@register_layer
class ResidualBlock(Layer):
    def __init__(self, layer_name, layer_list=None, skip_projection=None,
                 post_skip_activation=None):
        super().__init__(layer_name)
        if layer_list and post_skip_activation is None:
            # a bare ResidualBlock(name) is the load_from_h5 path
            raise ValueError(
                "ResidualBlock '{}' built with a layer_list needs a "
                "post_skip_activation — use ReLu(...) or, for a linear "
                "join, IdentityLayer(...)".format(layer_name))
        self.layer_list = nn.ModuleList(layer_list or [])
        self.skip_projection = skip_projection
        self.post_skip_activation = post_skip_activation

    def __repr__(self):
        return "ResidualBlock({}, layer_list={}, skip_projection={}, post_skip_activation={})".format(
            self.layer_name, list(self.layer_list), self.skip_projection,
            self.post_skip_activation)

    def _children(self):
        out = list(self.layer_list)
        if self.skip_projection is not None:
            out.append(self.skip_projection)
        if self.post_skip_activation is not None:
            out.append(self.post_skip_activation)
        return out

    def bn_initialized(self):
        return all(c.bn_initialized() for c in self._children())

    def _tree(self, get):
        return {
            "layers": [get(l) for l in self.layer_list],
            "skip": get(self.skip_projection) if self.skip_projection is not None else {},
            "act": get(self.post_skip_activation),
        }

    def get_params(self):
        return self._tree(lambda l: l.get_params())

    def get_state(self):
        return self._tree(lambda l: l.get_state())

    def get_grads(self):
        return self._tree(lambda l: l.get_grads())

    def set_grads(self, tree):
        for l, t in zip(self.layer_list, tree["layers"], strict=True):
            l.set_grads(t)
        if self.skip_projection is not None:
            self.skip_projection.set_grads(tree["skip"])
        self.post_skip_activation.set_grads(tree["act"])

    def reg_loss(self):
        """The reference's accounting: layer_list only."""
        total = 0.0
        for l in self.layer_list:
            total = total + l.reg_loss()
        return total

    def reg_loss_full(self):
        """Every regulariser, the skip projection's included: what the
        reference's applied gradient contains."""
        total = self.reg_loss()
        if self.skip_projection is not None:
            total = total + self.skip_projection.reg_loss()
        return total

    def set_params(self, tree):
        for l, t in zip(self.layer_list, tree["layers"], strict=True):
            l.set_params(t)
        if self.skip_projection is not None:
            self.skip_projection.set_params(tree["skip"])
        self.post_skip_activation.set_params(tree["act"])

    def set_state(self, tree):
        for l, t in zip(self.layer_list, tree["layers"], strict=True):
            l.set_state(t)
        if self.skip_projection is not None:
            self.skip_projection.set_state(tree["skip"])
        self.post_skip_activation.set_state(tree["act"])

    def fapply(self, x, train=False):
        h = x
        for l in self.layer_list:
            h = l.fapply(h, train)
        skip = x
        if self.skip_projection is not None:
            skip = self.skip_projection.fapply(x, train)
        return self.post_skip_activation.fapply(h + skip, train)

    def save_to_h5(self, open_f, save_grads=True):
        attrs = {
            "layer_type_list": [l.__class__.__name__ for l in self.layer_list],
            "layer_name_list": [l.layer_name for l in self.layer_list],
            "post_skip_activation_type": self.post_skip_activation.__class__.__name__,
            "post_skip_activation_name": self.post_skip_activation.layer_name,
        }
        if self.skip_projection is not None:
            attrs["skip_projection_type"] = self.skip_projection.__class__.__name__
            attrs["skip_projection_name"] = self.skip_projection.layer_name
        h5io.create_layer_info(open_f, self.layer_name, "ResidualBlock", **attrs)
        for l in self._children():
            l.save_to_h5(open_f, save_grads=save_grads)

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        for l_type, layer_name in zip(info["layer_type_list"], info["layer_name_list"]):
            layer = get_layer_class(l_type)(layer_name)
            layer.load_from_h5(open_f, load_grads=load_grads)
            self.layer_list.append(layer)
        if info.get("skip_projection_type", None):
            self.skip_projection = get_layer_class(info["skip_projection_type"])(
                info["skip_projection_name"])
            self.skip_projection.load_from_h5(open_f, load_grads=load_grads)
        self.post_skip_activation = get_layer_class(info["post_skip_activation_type"])(
            info["post_skip_activation_name"])
        self.post_skip_activation.load_from_h5(open_f, load_grads=load_grads)
