"""Batch normalisation layer (counterpart of
``dorknet_tpu/layers/batch_norm.py``).

gamma/beta are stored in the reference's broadcast shape, (1,C,1,1) for a
4-D input and (C,) for a 2-D one, and so are the running mean and running
**std** (eps folded in). The running stats are buffers that stay unset until
the first training batch, a checkpoint or ``set_state`` provides them; a
test-mode forward before that raises. A train-mode forward normalises by the
batch statistics; the first one adopts them as the running stats, later ones
fold them in with the running-std EMA at ``run_momentum`` (0.95)."""

import numpy as np
import torch
from torch import nn

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train


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
        for name in ("running_mean", "running_std"):
            v = np.asarray(tree[name], dtype=np.float32)
            if v.shape != shape:
                raise ValueError("{}/{}: expected shape {}, got {}".format(
                    self.layer_name, name, shape, v.shape))
            setattr(self, name, torch.from_numpy(v.copy()).to(device))

    def fapply(self, x, train=False):
        if train:
            y, mean, std = batch_norm_train(
                x, self.gamma.reshape(-1), self.beta.reshape(-1),
                None if self.running_mean is None else self.running_mean.reshape(-1),
                None if self.running_std is None else self.running_std.reshape(-1),
                momentum=self.run_momentum, eps=self.eps,
                initialized=self.bn_initialized())
            shape = self._state_shape()
            with torch.no_grad():
                self.running_mean = mean.reshape(shape)
                self.running_std = std.reshape(shape)
            return y
        if self.running_mean is None:
            raise ValueError(
                "BatchNormLayer '{}' has no running statistics; load a "
                "checkpoint or set_state first".format(self.layer_name))
        return batch_norm_inference(x, self.gamma.reshape(-1), self.beta.reshape(-1),
                                    self.running_mean.reshape(-1),
                                    self.running_std.reshape(-1))

    def load_from_h5(self, open_f):
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
