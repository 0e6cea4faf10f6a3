"""FeedForwardNetwork — the reference container API as an ``nn.Module``
(counterpart of ``dorknet_tpu/network/feed_forward_network.py``).

The layers live in an ``nn.ModuleList`` and run eagerly, one after another,
over NHWC activations. ``forward(X, test_mode=True)`` returns ``(0, probs)``
as the reference does. ``forward(X, y_one_hot)`` is a training forward: it
runs the layers in train mode (batch norm updates its running statistics),
returns ``(loss, probs)`` and computes, in the same call, the gradient of
the data loss plus every regularisation term with respect to every
parameter; ``backward()`` then hands each layer its gradients, and
``optimiser.update_weights()`` applies them. The reported loss uses the
reference's accounting, which leaves out the skip projections' terms
(``ResidualBlock.reg_loss``). ``forward(X, terminal_layer_name=name)`` is
the reference's feature tap: it runs the layers up to the named top-level
layer and returns ``(0, its NCHW output)``; in train mode batch norm
normalises by the batch statistics and, unlike the reference, leaves its
running stats as they are. ``test`` is the reference's accuracy loop.
Weights come from a reference h5+json checkpoint
(``load_network_from_json_and_h5``; ``save_weights_to_h5`` and
``save_layer_structure_to_json`` write one), from the seeded constructors
(bit-equal to the JAX package's under the same ``np.random.seed``), or from
the JAX network's own trees (``load_numpy_params``). ``_version`` counts
changes to the layer list and the loss layer, as the JAX network's does; a
trainer keys its captured steps on it.
"""

import json

import numpy as np
import torch
from torch import nn

# importing the layers package (through any of its modules) fills the registry
from dorknet_tpu_torch.layers.base import Layer, to_nchw, to_nhwc
from dorknet_tpu_torch.layers.batch_norm import running_stats_frozen
from dorknet_tpu_torch.layers.losses import SoftmaxWithCrossEntropy
from dorknet_tpu_torch.layers.registry import get_layer_class
from dorknet_tpu_torch.layers.sequence import run_layers
from dorknet_tpu_torch.ops.loss import softmax_probs


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, np.ndarray):  # grads read from an h5 file
        return tree.copy()
    # a copy: training updates the parameters in place
    return tree.detach().to("cpu", copy=True).numpy()


def _tap_index(net, terminal_layer_name):
    """The index of the top-level layer called ``terminal_layer_name``."""
    for i, l in enumerate(net.layers):
        if l.layer_name == terminal_layer_name:
            return i
    raise ValueError(
        "terminal_layer_name '{}' matches no layer (have: {})".format(
            terminal_layer_name, [l.layer_name for l in net.layers]))


class FeedForwardNetwork(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleList()
        self.loss_layer = None
        self._pending_grads = None
        # shadows nn.Module's class attribute, which only labels this
        # module's own entry of a state_dict's metadata
        self._version = 0

    def __repr__(self):
        out = "{}: \n".format(self.name)
        for l in self.layers:
            out += "\t" + l.__repr__() + "\n"
        return out

    def add_layer(self, layer):
        self.layers.append(layer)
        self._version += 1

    def set_loss_layer(self, loss_layer):
        self.loss_layer = loss_layer
        self._version += 1

    def device(self):
        """The device of the parameters (CPU for a network without any)."""
        p = next(self.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    # ------------------------------------------------------------------ #
    def _run_layers(self, x, train=False, layer_wrap=None):
        """Every layer over NHWC x (``layers/sequence.run_layers``: in train
        mode a batch norm and the ReLU or hard-swish after it as one call).
        Returns (out, reported_reg, full_reg): the regularisation terms are
        summed in train mode only (0.0 otherwise), layer by layer.
        layer_wrap(layer, apply) may return a transformed apply (the
        trainer's per-block rematerialisation)."""
        x = run_layers(self.layers, x, train, layer_wrap)
        reported_reg = full_reg = 0.0
        if train:
            for l in self.layers:
                reported_reg = reported_reg + l.reg_loss()
                full_reg = full_reg + l.reg_loss_full()
        return x, reported_reg, full_reg

    def _run_prefix(self, x, index, train=False):
        """layers[0..index] over NHWC x; the rest do not run (a batch norm
        at ``index`` fuses nothing after it)."""
        return run_layers(self.layers[:index + 1], x, train)

    def _test_fn(self, X):
        """Test-mode forward of an NCHW float32 tensor on the network's
        device: softmax probs when a loss layer is set, else the NCHW
        output of the last layer."""
        x, _, _ = self._run_layers(to_nhwc(X))
        if self.loss_layer is not None:
            return softmax_probs(x)
        return to_nchw(x)

    def _train_forward(self, x):
        """A train-mode pass over NHWC x without gradients: batch norm
        normalises by the batch statistics and updates its running stats.
        Returns the last layer's NHWC output."""
        with torch.no_grad():
            out, _, _ = self._run_layers(x, train=True)
        return out

    def _loss_and_grads(self, x, y_one_hot, params, run=None):
        """One training forward and backward over NHWC x. Returns (loss,
        probs, grads): the reported loss (detached), the softmax probs, and
        the gradient of data loss + every regularisation term for each of
        ``params``, in that order. Batch norm's running stats are updated.
        run(x) -> (out, reported_reg, full_reg) replaces the train-mode
        ``_run_layers`` (the trainer's rematerialised forward)."""
        with torch.enable_grad():
            if run is None:
                out, reported_reg, full_reg = self._run_layers(x, train=True)
            else:
                out, reported_reg, full_reg = run(x)
            data_loss, probs = self.loss_layer.fapply_loss(out, y_one_hot)
            grads = torch.autograd.grad(data_loss + full_reg, params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return (data_loss + reported_reg).detach(), probs, grads

    def forward(self, X, y_one_hot=None, test_mode=False, terminal_layer_name=None):
        """test_mode: ``(0, probs)`` (or the last layer's NCHW output
        without a loss layer). Train mode with a loss layer: ``(loss,
        probs)``, the gradients kept for ``backward()``; without one, ``(0,
        output)`` after a train-mode pass that updates batch norm's running
        stats. With ``terminal_layer_name``: ``(0, the NCHW output of that
        top-level layer)``, the later layers not run; in test mode only the
        layers up to it need set running stats, in train mode batch norm
        normalises by the batch statistics and moves no running stat."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device())
        if terminal_layer_name is not None:
            index = _tap_index(self, terminal_layer_name)
            if test_mode:
                self._require_bn_initialized("test-mode feature tap",
                                             layers=self.layers[:index + 1])
                with torch.inference_mode():
                    return 0, to_nchw(self._run_prefix(to_nhwc(X), index))
            with torch.no_grad(), running_stats_frozen(self):
                return 0, to_nchw(self._run_prefix(to_nhwc(X), index, train=True))
        if test_mode:
            self._require_bn_initialized("test-mode forward")
            with torch.inference_mode():
                return 0, self._test_fn(X)
        if self.loss_layer is None:
            return 0, to_nchw(self._train_forward(to_nhwc(X)))
        y = torch.as_tensor(y_one_hot, dtype=torch.float32, device=X.device)
        params = list(self.parameters())
        loss, probs, grads = self._loss_and_grads(to_nhwc(X), y, params)
        self._pending_grads = dict(zip(params, grads))
        return loss, probs

    def backward(self):
        """Hand each layer the gradients of the last training forward (the
        reference computes them layer by layer here; this forward already
        did)."""
        if self.loss_layer is None:
            raise ValueError("Network doesn't have a loss, can't run backward pass.")
        if self._pending_grads is None:
            raise RuntimeError("backward() called before a training-mode forward()")
        for l in self.modules():
            if isinstance(l, Layer):
                l.grads = {name: self._pending_grads[p]
                           for name, p in l.named_parameters(recurse=False)}
        self._pending_grads = None

    def _require_bn_initialized(self, what, layers=None):
        """Inference normalises by the running stats: refuse to run before
        they were set, naming the layers that lack them. ``layers``
        restricts the check to a subset (the trunk before a feature tap)."""
        layers = self.layers if layers is None else layers
        bad = [l.layer_name for l in layers if not l.bn_initialized()]
        if bad:
            raise ValueError(
                "{} needs initialised batch-norm running statistics; run a "
                "training batch, load a checkpoint or set them first "
                "(uninitialised: {})".format(what, bad))

    def test(self, data_loader, batch_size, test_set_size):
        """The reference's accuracy loop over ``data_loader``'s (X, y, ...)
        batches: a test-mode forward and the argmax on the network's
        device, the compare with the labels y on the host. Returns the
        correct count divided by ``test_set_size``."""
        self._require_bn_initialized("test()")
        device = self.device()
        correct = 0
        with torch.inference_mode():
            for X_batch, y_batch, *_ in data_loader:
                X = torch.as_tensor(X_batch, dtype=torch.float32).to(device, non_blocking=True)
                pred = self._test_fn(X).argmax(dim=1).cpu().numpy()
                correct += int(np.sum(np.asarray(y_batch) == pred))
        return float(correct) / test_set_size

    # ------------------------------------------------------------------ #
    # Parameter trees, in the JAX package's shape
    # ------------------------------------------------------------------ #
    def gather_params(self):
        """One entry per layer, every leaf a numpy array."""
        return [_to_numpy(l.get_params()) for l in self.layers]

    def gather_states(self):
        return [_to_numpy(l.get_state()) for l in self.layers]

    def gather_grads(self):
        """The gradients the last ``backward()`` set, in the shape of
        ``gather_params()``."""
        return [_to_numpy(l.get_grads()) for l in self.layers]

    def load_numpy_params(self, params, states=None):
        """Fill the parameters, and the running stats when ``states`` is
        given, from the JAX network's ``gather_params()``/``gather_states()``
        trees with every leaf converted to numpy. The layouts are identical,
        so nothing is transposed; a shape that differs raises. With
        ``states`` None every batch norm stays as it is: a fresh network's
        stay unset, so its first training batch adopts the batch statistics
        (the JAX package's zeros placeholders of an unset state are not
        running statistics and must not be carried across)."""
        n = len(self.layers)
        if len(params) != n or (states is not None and len(states) != n):
            raise ValueError("expected {} layer entries, got {} params and {} states"
                             .format(n, len(params), "no" if states is None else len(states)))
        for i, l in enumerate(self.layers):
            l.set_params(params[i])
            if states is not None:
                l.set_state(states[i])

    # ------------------------------------------------------------------ #
    # Checkpoints (the reference's h5+json schema; h5py is imported only
    # here, since the card's machine has none)
    # ------------------------------------------------------------------ #
    def save_weights_to_h5(self, fname):
        """Every layer, then the loss layer, in the reference's h5 schema."""
        import h5py

        with h5py.File(fname, "w") as f:
            for layer in self.layers:
                layer.save_to_h5(f)
            if self.loss_layer is not None:
                self.loss_layer.save_to_h5(f)

    def save_layer_structure_to_json(self, fname):
        """The layer order as the reference writes it: the name, then each
        layer's repr by layer name."""
        structure_dict = {"name": self.name}
        for layer in self.layers:
            structure_dict[layer.layer_name] = repr(layer)
        if self.loss_layer is not None:
            structure_dict[self.loss_layer.layer_name] = repr(self.loss_layer)
        with open(fname, "w") as f:
            json.dump(structure_dict, f, indent=4)

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
                    self.set_loss_layer(SoftmaxWithCrossEntropy(layer_name))
                    continue
                l = get_layer_class(l_type)(layer_name)
                l.load_from_h5(f)
                self.add_layer(l)
