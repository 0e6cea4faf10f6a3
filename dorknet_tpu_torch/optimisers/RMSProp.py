"""RMSProp in the reference's accumulator form (counterpart of
``dorknet_tpu/optimisers/RMSProp.py``):

    c = d*c + (1-d)*g^2 ;  W -= lr * g / sqrt(c + 1e-5)
"""

import torch

from dorknet_tpu_torch.optimisers.base import Optimiser


class RMSProp(Optimiser):
    def __init__(self, network, learning_rate, decay_rate):
        super().__init__(network, learning_rate)
        self.decay_rate = decay_rate

    def hyper_key(self):
        return (float(self.decay_rate),)

    def apply_update(self, params, grads, cache, lr):
        d = self.decay_rate
        torch._foreach_mul_(cache, d)
        torch._foreach_add_(cache, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - d))
        denom = torch._foreach_sqrt(torch._foreach_add(cache, 1e-5))
        torch._foreach_sub_(params, torch._foreach_div(torch._foreach_mul(grads, lr), denom))
        return cache
