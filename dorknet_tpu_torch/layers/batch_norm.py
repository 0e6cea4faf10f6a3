"""Batch normalisation layer (counterpart of
``dorknet_tpu/layers/batch_norm.py``).

gamma/beta are stored in the reference's broadcast shape, (1,C,1,1) for a
4-D input and (C,) for a 2-D one, and so are the running mean and running
**std** (eps folded in). The running stats are buffers that stay unset until
the first training batch, a checkpoint or ``set_state`` provides them; a
test-mode forward before that raises. A train-mode forward normalises by the
batch statistics; the first one adopts them as the running stats, later ones
fold them in with the running-std EMA at ``run_momentum`` (0.95).

Once they exist, the running stats are written in place (``copy_``), by
training and by ``set_state`` alike, so they keep one address: a captured
CUDA graph of a training step reads and writes the live buffers. Inside
``running_stats_frozen(module)`` a train-mode forward of the module's batch
norms normalises by the batch statistics and leaves the running stats as
they are: a rematerialised forward (``Trainer(remat=...)``) recomputes a
batch's activations in the backward, and must not fold its statistics in
a second time. The switch is a flag on each layer, not a thread-local:
the autograd engine runs a CUDA backward, and with it the recomputation,
on a thread of its own."""

import contextlib

import numpy as np
import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train
from dorknet_tpu_torch.utils import h5io


@register_layer
class BatchNormLayer(Layer):
    def __init__(self, layer_name, input_dimension=4,
                 incoming_chans=None, run_momentum=0.95):
        super().__init__(layer_name)
        self.eps = 1e-5
        if input_dimension not in {2, 4}:
            raise ValueError("BatchNorm input_dimension should have length 2 or 4...")
        self.input_dimension = input_dimension
        self.run_momentum = run_momentum
        self.incoming_chans = incoming_chans
        self.register_buffer("running_mean", None)
        self.register_buffer("running_std", None)
        self.stats_frozen = False  # set by running_stats_frozen
        if incoming_chans is not None:
            shape = self._state_shape()
            self.gamma = nn.Parameter(torch.ones(shape))
            self.beta = nn.Parameter(torch.zeros(shape))

    def __repr__(self):
        return "BatchNormLayer({}, input_dimension={}, incoming_chans={}, run_momentum={})".format(
            self.layer_name, self.input_dimension, self.incoming_chans, self.run_momentum)

    def bn_initialized(self):
        return self.running_mean is not None

    def _state_shape(self):
        C = int(self.incoming_chans)
        return (1, C, 1, 1) if self.input_dimension == 4 else (C,)

    def get_state(self):
        """Running stats in their stored broadcast shape; zeros placeholders
        while unset, as the JAX package returns."""
        if self.running_mean is None:
            z = torch.zeros(self._state_shape())
            return {"running_mean": z, "running_std": z}
        return {"running_mean": self.running_mean, "running_std": self.running_std}

    def set_state(self, tree):
        shape = self._state_shape()
        device = self.gamma.device
        values = {}
        for name in ("running_mean", "running_std"):
            v = np.asarray(tree[name], dtype=np.float32)
            if v.shape != shape:
                raise ValueError("{}/{}: expected shape {}, got {}".format(
                    self.layer_name, name, shape, v.shape))
            values[name] = torch.from_numpy(v.copy())
        self._write_running_stats(values["running_mean"], values["running_std"], device)

    def _write_running_stats(self, mean, std, device):
        """Copy into the running stats where they exist; else make them (a
        fresh layer's adoption, an ordinary Python branch)."""
        shape = self._state_shape()
        with torch.no_grad():
            if self.running_mean is None:
                self.running_mean = mean.reshape(shape).to(device)
                self.running_std = std.reshape(shape).to(device)
            else:
                self.running_mean.copy_(mean.reshape(shape))
                self.running_std.copy_(std.reshape(shape))

    def fapply(self, x, train=False, act="none"):
        """``act`` ("relu" or "hswish", train mode only) applies the
        activation that follows in the batch norm's own kernels
        (``layers/sequence.py`` passes it)."""
        if train:
            fold = self.bn_initialized() and not self.stats_frozen
            y, mean, std = batch_norm_train(
                x, self.gamma.reshape(-1), self.beta.reshape(-1),
                self.running_mean.reshape(-1) if fold else None,
                self.running_std.reshape(-1) if fold else None,
                momentum=self.run_momentum, eps=self.eps, initialized=fold, act=act)
            if not self.stats_frozen:
                self._write_running_stats(mean, std, x.device)
            return y
        if act != "none":
            raise ValueError("BatchNormLayer '{}': act={!r} runs in train mode only".format(
                self.layer_name, act))
        if self.running_mean is None:
            raise ValueError(
                "BatchNormLayer '{}' has no running statistics; load a "
                "checkpoint or set_state first".format(self.layer_name))
        return batch_norm_inference(x, self.gamma.reshape(-1), self.beta.reshape(-1),
                                    self.running_mean.reshape(-1),
                                    self.running_std.reshape(-1))

    def save_to_h5(self, open_f, save_grads=True):
        if self.running_mean is None:
            raise ValueError(
                "BatchNormLayer '{}' has no running statistics yet; run at "
                "least one training batch (or load a checkpoint) before "
                "saving".format(self.layer_name))
        h5io.create_layer_info(
            open_f, self.layer_name, "BatchNormLayer",
            input_dimension=self.input_dimension, run_momentum=self.run_momentum,
            incoming_chans=self.incoming_chans, eps=self.eps)
        for name in ("gamma", "beta", "running_mean", "running_std"):
            h5io.save_array(open_f, self.layer_name + "/" + name, getattr(self, name))
        if save_grads:
            grads = self._grads_to_save()
            for name in ("gamma", "beta"):
                h5io.save_array(open_f, "{}/grads/{}".format(self.layer_name, name),
                                grads[name])

    def load_from_h5(self, open_f, load_grads=True):
        info = open_f[self.layer_name + "/layer_info"].attrs
        self.eps = float(info["eps"])
        self.incoming_chans = int(info["incoming_chans"])
        self.input_dimension = int(info["input_dimension"])
        self.run_momentum = float(info["run_momentum"])
        if self.input_dimension not in {2, 4}:
            raise ValueError("BatchNorm input_dimension should have length 2 or 4...")

        def read(name):
            return torch.from_numpy(np.asarray(
                open_f[self.layer_name + "/" + name][:], dtype=np.float32))

        self.gamma = nn.Parameter(read("gamma"))
        self.beta = nn.Parameter(read("beta"))
        self.running_mean = read("running_mean")
        self.running_std = read("running_std")
        if load_grads:
            self.grads = {name: read("grads/" + name).numpy() for name in ("gamma", "beta")}


@contextlib.contextmanager
def running_stats_frozen(module):
    """Inside, the train-mode batch norms of ``module`` (any nn.Module) leave
    their running stats unchanged."""
    layers = [m for m in module.modules() if isinstance(m, BatchNormLayer)]
    for layer in layers:
        layer.stats_frozen = True
    try:
        yield
    finally:
        for layer in layers:
            layer.stats_frozen = False
