"""Residual block (counterpart of ``dorknet_tpu/layers/residual_block.py``):
``layer_list`` runs in sequence, ``skip_projection`` (or identity) bridges
the input, the two join by addition and ``post_skip_activation`` follows.
Parameter, state and gradient trees are ``{"layers": [...], "skip": {...},
"act": {...}}``, as in the JAX package; the h5 schema (flat-namespace
children plus attr-encoded structure) is the reference's.

``skip_bn``, a batch norm after the skip projection (ResNet-50 v1.5's
projection shortcuts), is the port's own: the JAX package has none. A block
with one adds ``"skip_bn"`` to its trees and ``skip_bn_type`` /
``skip_bn_name`` to its h5 attrs, which the JAX package cannot read; a
block without one writes exactly what it wrote before.

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
                 post_skip_activation=None, skip_bn=None):
        super().__init__(layer_name)
        if layer_list and post_skip_activation is None:
            # a bare ResidualBlock(name) is the load_from_h5 path
            raise ValueError(
                "ResidualBlock '{}' built with a layer_list needs a "
                "post_skip_activation — use ReLu(...) or, for a linear "
                "join, IdentityLayer(...)".format(layer_name))
        self.layer_list = nn.ModuleList(layer_list or [])
        if skip_bn is not None and skip_projection is None:
            raise ValueError("ResidualBlock '{}': a skip_bn needs a skip_projection".format(
                layer_name))
        self.skip_projection = skip_projection
        self.skip_bn = skip_bn
        self.post_skip_activation = post_skip_activation

    def __repr__(self):
        out = "ResidualBlock({}, layer_list={}, skip_projection={}, ".format(
            self.layer_name, list(self.layer_list), self.skip_projection)
        if self.skip_bn is not None:
            out += "skip_bn={}, ".format(self.skip_bn)
        return out + "post_skip_activation={})".format(self.post_skip_activation)

    def _children(self):
        out = list(self.layer_list)
        if self.skip_projection is not None:
            out.append(self.skip_projection)
        if self.skip_bn is not None:
            out.append(self.skip_bn)
        if self.post_skip_activation is not None:
            out.append(self.post_skip_activation)
        return out

    def bn_initialized(self):
        return all(c.bn_initialized() for c in self._children())

    def _tree(self, get):
        tree = {
            "layers": [get(l) for l in self.layer_list],
            "skip": get(self.skip_projection) if self.skip_projection is not None else {},
            "act": get(self.post_skip_activation),
        }
        if self.skip_bn is not None:
            tree["skip_bn"] = get(self.skip_bn)
        return tree

    def _set(self, tree, set_one):
        """set_one(layer, subtree) over the children, as ``_tree`` lays
        them out."""
        for l, t in zip(self.layer_list, tree["layers"], strict=True):
            set_one(l, t)
        if self.skip_projection is not None:
            set_one(self.skip_projection, tree["skip"])
        if self.skip_bn is not None:
            set_one(self.skip_bn, tree["skip_bn"])
        set_one(self.post_skip_activation, tree["act"])

    def get_params(self):
        return self._tree(lambda l: l.get_params())

    def get_state(self):
        return self._tree(lambda l: l.get_state())

    def get_grads(self):
        return self._tree(lambda l: l.get_grads())

    def set_grads(self, tree):
        self._set(tree, lambda l, t: l.set_grads(t))

    def reg_loss(self):
        """The reference's accounting: layer_list only."""
        total = 0.0
        for l in self.layer_list:
            total = total + l.reg_loss()
        return total

    def reg_loss_full(self):
        """Every regulariser, the skip projection's included: what the
        reference's applied gradient contains (a skip_bn carries none)."""
        total = self.reg_loss()
        if self.skip_projection is not None:
            total = total + self.skip_projection.reg_loss()
        return total

    def set_params(self, tree):
        self._set(tree, lambda l, t: l.set_params(t))

    def set_state(self, tree):
        self._set(tree, lambda l, t: l.set_state(t))

    def fapply(self, x, train=False):
        h = x
        for l in self.layer_list:
            h = l.fapply(h, train)
        skip = x
        if self.skip_projection is not None:
            skip = self.skip_projection.fapply(x, train)
        if self.skip_bn is not None:
            skip = self.skip_bn.fapply(skip, train)
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
        if self.skip_bn is not None:
            attrs["skip_bn_type"] = self.skip_bn.__class__.__name__
            attrs["skip_bn_name"] = self.skip_bn.layer_name
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
        if info.get("skip_bn_type", None):
            self.skip_bn = get_layer_class(info["skip_bn_type"])(info["skip_bn_name"])
            self.skip_bn.load_from_h5(open_f, load_grads=load_grads)
        self.post_skip_activation = get_layer_class(info["post_skip_activation_type"])(
            info["post_skip_activation_name"])
        self.post_skip_activation.load_from_h5(open_f, load_grads=load_grads)
