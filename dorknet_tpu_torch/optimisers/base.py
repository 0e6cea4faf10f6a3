"""Optimiser base (counterpart of ``dorknet_tpu/optimisers/base.py``).

``apply_update(params, grads, cache, lr)`` is each rule's whole update over
flat lists of tensors: it changes ``params`` in place (under
``torch.no_grad()``, with ``torch._foreach_*`` ops, a few launches for the
whole list) and returns the new cache. ``Trainer.step`` calls it with its own
cache; ``update_weights()`` is the reference-compatible call, which applies
the gradients the last ``network.backward()`` handed to the layers.

Updates reach every parameter of every nested child, a residual block's
skip projection included, as the JAX package fixed the reference's
traversal.
"""

import torch

from dorknet_tpu_torch.layers.base import Layer


class Optimiser:
    def __init__(self, network, learning_rate):
        self.network = network
        self.learning_rate = learning_rate
        self.grad_cache = None

    def set_learning_rate(self, new_lr):
        self.learning_rate = new_lr

    def multiply_learning_rate(self, multiplier):
        self.learning_rate *= multiplier

    def init_cache(self, params):
        """The optimiser state for ``params``: one zero tensor per parameter
        (an empty list for a stateless rule)."""
        return [torch.zeros_like(p) for p in params]

    def apply_update(self, params, grads, cache, lr):
        """Update ``params`` in place from ``grads``; return the new cache."""
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
                grads.append(layer.grads[name])
        return params, grads

    def update_weights(self):
        params, grads = self._params_and_grads()
        if self.grad_cache is None:
            self.grad_cache = self.init_cache(params)
        with torch.no_grad():
            self.grad_cache = self.apply_update(params, grads, self.grad_cache,
                                                self.learning_rate)
