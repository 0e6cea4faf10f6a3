"""Plain SGD: W -= lr * g (counterpart of ``dorknet_tpu/optimisers/SGD.py``)."""

import torch

from dorknet_tpu_torch.optimisers.base import Optimiser


class SGD(Optimiser):
    def init_cache(self, params):
        return []

    def apply_update(self, params, grads, cache, lr):
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
        return cache
