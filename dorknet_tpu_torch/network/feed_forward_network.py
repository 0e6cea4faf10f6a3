"""FeedForwardNetwork — the reference container API as an ``nn.Module``
(counterpart of ``dorknet_tpu/network/feed_forward_network.py``).

The layers live in an ``nn.ModuleList`` and run eagerly, one after another,
over NHWC activations. This slice is test mode only: ``forward(X,
test_mode=True)`` returns ``(0, probs)`` as the reference does. Weights come
from a reference h5+json checkpoint (``load_network_from_json_and_h5``), from
the seeded constructors (bit-equal to the JAX package's under the same
``np.random.seed``), or from the JAX network's own trees
(``load_numpy_params``).
"""

import json

import torch
from torch import nn

# importing the layers package (through any of its modules) fills the registry
from dorknet_tpu_torch.layers.base import to_nchw, to_nhwc
from dorknet_tpu_torch.layers.losses import SoftmaxWithCrossEntropy
from dorknet_tpu_torch.layers.registry import get_layer_class
from dorknet_tpu_torch.ops.loss import softmax_probs


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


class FeedForwardNetwork(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleList()
        self.loss_layer = None

    def __repr__(self):
        out = "{}: \n".format(self.name)
        for l in self.layers:
            out += "\t" + l.__repr__() + "\n"
        return out

    def add_layer(self, layer):
        self.layers.append(layer)

    def set_loss_layer(self, loss_layer):
        self.loss_layer = loss_layer

    def device(self):
        """The device of the parameters (CPU for a network without any)."""
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    # ------------------------------------------------------------------ #
    def _run_layers(self, x):
        for l in self.layers:
            x = l.fapply(x)
        return x

    def _test_fn(self, X):
        """Test-mode forward of an NCHW float32 tensor on the network's
        device: softmax probs when a loss layer is set, else the NCHW
        output of the last layer."""
        x = self._run_layers(to_nhwc(X))
        if self.loss_layer is not None:
            return softmax_probs(x)
        return to_nchw(x)

    def forward(self, X, test_mode=True):
        if not test_mode:
            raise NotImplementedError(
                "train-mode forward comes with the training slice")
        self._require_bn_initialized("test-mode forward")
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device())
        with torch.inference_mode():
            return 0, self._test_fn(X)

    def _require_bn_initialized(self, what):
        """Inference normalises by the running stats: refuse to run before
        they were set, naming the layers that lack them."""
        bad = [l.layer_name for l in self.layers if not l.bn_initialized()]
        if bad:
            raise ValueError(
                "{} needs initialised batch-norm running statistics; load a "
                "checkpoint or set them first (uninitialised: {})".format(what, bad))

    # ------------------------------------------------------------------ #
    # Parameter trees, in the JAX package's shape
    # ------------------------------------------------------------------ #
    def gather_params(self):
        """One entry per layer, every leaf a numpy array."""
        return [_to_numpy(l.get_params()) for l in self.layers]

    def gather_states(self):
        return [_to_numpy(l.get_state()) for l in self.layers]

    def load_numpy_params(self, params, states):
        """Fill the parameters and running stats from the JAX network's
        ``gather_params()``/``gather_states()`` trees with every leaf
        converted to numpy. The layouts are identical, so nothing is
        transposed; a shape that differs raises."""
        if len(params) != len(self.layers) or len(states) != len(self.layers):
            raise ValueError("expected {} layer entries, got {} params and {} states"
                             .format(len(self.layers), len(params), len(states)))
        for l, p, s in zip(self.layers, params, states):
            l.set_params(p)
            l.set_state(s)

    # ------------------------------------------------------------------ #
    # Checkpoints (the reference's h5+json schema, read side)
    # ------------------------------------------------------------------ #
    def load_network_from_json_and_h5(self, json_fname, h5_fname):
        """The json gives the layer order; each h5 'type' attr gives the
        class."""
        import h5py

        with open(json_fname, "r") as f:
            json_structure = json.load(f)
        with h5py.File(h5_fname, "r") as f:
            self.name = json_structure.pop("name")
            for layer_name in json_structure:
                l_type = f[layer_name + "/layer_info"].attrs["type"]
                if l_type == "SoftmaxWithCrossEntropy":
                    self.loss_layer = SoftmaxWithCrossEntropy(layer_name)
                    continue
                l = get_layer_class(l_type)(layer_name)
                l.load_from_h5(f)
                self.layers.append(l)
