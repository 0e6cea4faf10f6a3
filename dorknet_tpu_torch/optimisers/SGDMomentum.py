"""SGD with momentum in the reference's velocity form (counterpart of
``dorknet_tpu/optimisers/SGDMomentum.py``):

    dx = -lr * g + momentum * v ;  W += dx ;  v = dx
"""

import torch

from dorknet_tpu_torch.optimisers.base import Optimiser


class SGDMomentum(Optimiser):
    def __init__(self, network, learning_rate, momentum):
        super().__init__(network, learning_rate)
        self.momentum = momentum

    def hyper_key(self):
        return (float(self.momentum),)

    def apply_update(self, params, grads, cache, lr):
        step = torch._foreach_mul(grads, -lr)
        torch._foreach_mul_(cache, self.momentum)
        torch._foreach_add_(cache, step)  # v = momentum * v - lr * g, in place
        torch._foreach_add_(params, cache)
        return cache
