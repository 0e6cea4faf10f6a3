"""AdamW (Loshchilov & Hutter, arXiv:1711.05101), as ``torch.optim.AdamW``
computes it, the port's own (the JAX package has none):

    w -= lr * wd * w                     (weights only: see below)
    m = b1 * m + (1 - b1) * g ;  v = b2 * v + (1 - b2) * g^2
    w -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)

The cache is the first moment of every parameter in
``network.parameters()`` order, then the second moments, then the step
count t, a 0-dim fp32 tensor on the parameters' device. The update adds 1
to t in place and takes both bias corrections from it on the device, so a
captured step that is replayed advances it, and a checkpoint
(``utils/torch_io``) saves and restores it with the moments.

The decay is decoupled, and applies to the parameters with two or more
axes longer than one, the weights of the conv, depthwise, pointwise and
dense layers, as ConvNeXt's recipe decays only its weights: biases,
LayerNorm and batch-norm gains and offsets (a batch norm's (1, C, 1, 1)
among them) and layer scales are not decayed.

The update runs inside the span ``adamw.update`` (``utils/tracing``).
"""

import torch

from dorknet_tpu_torch.optimisers.base import Optimiser
from dorknet_tpu_torch.utils.tracing import span


def decayed(p):
    """Whether AdamW decays parameter ``p``: two or more axes longer than
    one."""
    return sum(n > 1 for n in p.shape) >= 2


class AdamW(Optimiser):
    def __init__(self, network, learning_rate, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.05):
        super().__init__(network, learning_rate)
        self.beta1, self.beta2 = beta1, beta2
        self.eps, self.weight_decay = eps, weight_decay

    def hyper_key(self):
        return (float(self.beta1), float(self.beta2), float(self.eps), float(self.weight_decay))

    def init_cache(self, params):
        """Zero first and second moments of ``params``, then a zero step
        count on their device."""
        device = params[0].device if params else torch.device("cpu")
        return ([torch.zeros_like(p) for p in params] + [torch.zeros_like(p) for p in params]
                + [torch.zeros((), dtype=torch.float32, device=device)])

    def apply_update(self, params, grads, cache, lr):
        with span("adamw.update"):
            n = len(params)
            m, v, step = cache[:n], cache[n:2 * n], cache[2 * n]
            b1, b2 = self.beta1, self.beta2
            step.add_(1.0)
            decay = [p for p in params if decayed(p)]
            if decay and self.weight_decay:
                torch._foreach_mul_(decay, 1.0 - lr * self.weight_decay)
            torch._foreach_lerp_(m, grads, 1.0 - b1)  # b1 m + (1 - b1) g
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            step_size = lr / (1.0 - b1 ** step)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, torch.sqrt(1.0 - b2 ** step))
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(m, denom)
            torch._foreach_mul_(update, step_size)
            torch._foreach_sub_(params, update)
        return cache
