"""Optimiser base (counterpart of ``dorknet_tpu/optimisers/base.py``).

``apply_update(params, grads, cache, lr)`` is each rule's whole update over
flat lists of tensors: it changes ``params`` and the tensors of ``cache`` in
place (under ``torch.no_grad()``, with ``torch._foreach_*`` ops, a few
launches for the whole list) and returns the cache. ``Trainer.step`` calls it
with its own cache; ``update_weights()`` is the reference-compatible call,
which applies the gradients the last ``network.backward()`` handed to the
layers. Updating in place keeps every tensor of the step at one address, so
a captured CUDA graph of the step reads and writes the live state.

The learning rate lives twice: ``learning_rate``, the Python number the
schedules and the reference's scripts set, and ``device_lr()``, a 0-dim fp32
tensor on the network's device that every update reads. Setting
``learning_rate`` (directly, through ``set_learning_rate`` or
``multiply_learning_rate``) fills that tensor in place, so a change reaches
a replayed step without a new capture, as the JAX package's traced lr
reaches its compiled step without a retrace. ``hyper_key()`` names the
hyperparameters an update bakes in instead; a captured step is keyed on it.

Updates reach every parameter of every nested child, a residual block's
skip projection included, as the JAX package fixed the reference's
traversal.
"""

import torch

from dorknet_tpu_torch.layers.base import Layer


class Optimiser:
    def __init__(self, network, learning_rate):
        self.network = network
        self._lr = None  # the device scalar, made by the first device_lr()
        self.learning_rate = learning_rate
        self.grad_cache = None

    @property
    def learning_rate(self):
        return self._learning_rate

    @learning_rate.setter
    def learning_rate(self, value):
        self._learning_rate = value
        if self._lr is not None:
            self._lr.fill_(float(value))

    def set_learning_rate(self, new_lr):
        self.learning_rate = new_lr

    def multiply_learning_rate(self, multiplier):
        self.learning_rate *= multiplier

    def device_lr(self):
        """The learning rate as a 0-dim fp32 tensor on the network's device,
        made once per device and afterwards changed only in place."""
        device = self.network.device()
        if self._lr is None or self._lr.device != device:
            self._lr = torch.full((), float(self.learning_rate), dtype=torch.float32,
                                  device=device)
        return self._lr

    def hyper_key(self):
        """Every hyperparameter the update bakes in, as a hashable tuple (the
        lr is not one: it is read from ``device_lr()`` at every update)."""
        return ()

    def init_cache(self, params):
        """The optimiser state for ``params``: one zero tensor per parameter
        (an empty list for a stateless rule)."""
        return [torch.zeros_like(p) for p in params]

    def apply_update(self, params, grads, cache, lr):
        """Update ``params`` and ``cache`` in place from ``grads`` at
        learning rate ``lr`` (a 0-dim tensor or a number); return ``cache``."""
        raise NotImplementedError

    def _params_and_grads(self):
        params, grads = [], []
        for layer in self.network.modules():
            if not isinstance(layer, Layer):
                continue
            for name, p in layer.named_parameters(recurse=False):
                if name not in layer.grads:
                    raise RuntimeError(
                        "update_weights() needs the gradients of a training "
                        "forward() and backward(); layer '{}' has none for "
                        "'{}'".format(layer.layer_name, name))
                params.append(p)
                # a loaded checkpoint's grads are numpy arrays
                grads.append(torch.as_tensor(layer.grads[name], device=p.device))
        return params, grads

    def update_weights(self):
        params, grads = self._params_and_grads()
        if self.grad_cache is None:
            self.grad_cache = self.init_cache(params)
        with torch.no_grad():
            self.apply_update(params, grads, self.grad_cache, self.device_lr())
