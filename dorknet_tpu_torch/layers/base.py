"""Layer base class (counterpart of ``dorknet_tpu/layers/base.py``).

Layers are ``nn.Module``s. Learned parameters are ``nn.Parameter``s and batch
norm's running statistics are buffers, in the reference layouts the JAX
package keeps. Every layer implements ``fapply(x, train=False)`` over NHWC
activations (4-D) or (N,C); the network composes those. In train mode batch
norm normalises by the batch statistics and updates its running statistics
in place; every other layer computes the same function in both modes.
Activations cross the public API in the reference's NCHW layout and are
NHWC-contiguous inside.

``get_params``/``get_state``/``get_grads`` return the JAX package's tree
shapes (a dict per layer); ``set_params``/``set_state`` fill the parameters
and buffers from such trees of numpy arrays, without transposing anything.
``reg_loss`` is the regularisation term the reference reports and
``reg_loss_full`` the one its applied gradient contains (they differ only in
``ResidualBlock``).

``save_to_h5(open_f, save_grads=True)`` writes a layer in the reference's h5
schema and ``load_from_h5(open_f, load_grads=True)`` reads it back. The
``grads/...`` datasets hold the gradients of the last ``network.backward()``,
or of the last load, and zeros before either: the JAX layers start from
zeros, and only a ``backward()`` (its trainer never calls one) or a load
changes them. Like the JAX loader, ``load_from_h5`` reads the ``grads/...``
datasets into ``grads`` (numpy arrays) by default and raises KeyError on a
file written with ``save_grads=False``; ``load_grads=False`` reads such a
file and leaves ``grads`` as they were.
"""

import numpy as np
import torch
from torch import nn

from dorknet_tpu_torch.utils import h5io


def to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous() if x.dim() == 4 else x


def to_nchw(x):
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def copy_into(t, value, what):
    """Copy a numpy array into tensor ``t`` in place; shapes must match."""
    v = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(v.shape) != tuple(t.shape):
        raise ValueError("{}: expected shape {}, got {}".format(
            what, tuple(t.shape), tuple(v.shape)))
    with torch.no_grad():
        t.copy_(v)


class Layer(nn.Module):
    weight_regulariser = None

    def __init__(self, layer_name):
        super().__init__()
        self.layer_name = layer_name
        self.grads = {}  # name -> gradient of the last network backward()

    def __repr__(self):
        return "Layer of type {} didn't implement __repr__".format(
            self.__class__.__name__)

    def fapply(self, x, train=False):
        """Apply to x, NHWC (4-D) or (N,C). Returns y."""
        raise NotImplementedError

    def reg_loss(self):
        """The regularisation term this layer reports (0.0 without one)."""
        if self.weight_regulariser is not None:
            return self.weight_regulariser.forward(self.weights)
        return 0.0

    def reg_loss_full(self):
        """Every regularisation term this layer's gradient contains."""
        return self.reg_loss()

    def get_params(self):
        """This layer's learned parameters by name (no copy)."""
        return dict(self.named_parameters(recurse=False))

    def set_params(self, tree):
        for name, p in self.named_parameters(recurse=False):
            copy_into(p, tree[name], "{}/{}".format(self.layer_name, name))

    def get_grads(self):
        """The gradients the last ``network.backward()`` set, by name, in
        the shape of ``get_params()`` ({} before one)."""
        return dict(self.grads)

    def set_grads(self, tree):
        self.grads = {name: tree[name] for name, _ in self.named_parameters(recurse=False)
                      if name in tree}

    def get_state(self):
        """Non-learned state (batch-norm running stats); stateless layers {}."""
        return {}

    def set_state(self, tree):
        pass

    def bn_initialized(self):
        """True unless the layer (or a nested child) carries batch-norm
        running stats that were never set."""
        return True

    def save_to_h5(self, open_f, save_grads=True):
        raise NotImplementedError

    def load_from_h5(self, open_f, load_grads=True):
        raise NotImplementedError

    def _grads_to_save(self):
        """Each parameter's gradient from the last ``network.backward()`` or
        load, or zeros of its shape before either (the JAX layers' initial
        grads)."""
        return {name: self.grads[name] if name in self.grads
                else np.zeros(tuple(p.shape), np.float32)
                for name, p in self.named_parameters(recurse=False)}

    def _save_weights_to_h5(self, open_f, save_grads):
        """The weights/bias/grads block shared by the conv, depthwise,
        pointwise and dense layers: the twin of ``_load_weights_from_h5``."""
        h5io.save_param_datasets(open_f, self.layer_name, self.get_params(),
                                 self._grads_to_save(), self.weight_regulariser,
                                 self.with_bias, save_grads=save_grads)

    def _load_weights_from_h5(self, open_f, load_grads):
        """The weights/bias/regulariser/grads block shared by the conv,
        depthwise, pointwise and dense layers (``self.with_bias`` already
        read)."""
        w, b, self.weight_regulariser, grads = h5io.load_param_datasets(
            open_f, self.layer_name, self.with_bias, load_grads=load_grads)
        self.weights = nn.Parameter(torch.from_numpy(w))
        if b is not None:
            self.bias = nn.Parameter(torch.from_numpy(b))
        if load_grads:
            self.grads = grads


def init_weights(shape, initialiser, fan_in, fan_out):
    """Reference init recipes, drawn with host ``np.random`` exactly as the
    JAX package draws them: glorot_uniform uses sqrt(6/(fan_in+fan_out)) over
    the channel counts; "normal" is 0.01*randn. With the same
    ``np.random.seed`` and construction order both packages build bit-equal
    weights."""
    if initialiser == "glorot_uniform":
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        w = np.random.uniform(low=-limit, high=limit, size=shape).astype(np.float32)
    elif initialiser == "normal":
        w = (0.01 * np.random.randn(*shape)).astype(np.float32)
    else:
        raise ValueError("Unknown weight_initialiser {}".format(initialiser))
    return torch.from_numpy(w)
