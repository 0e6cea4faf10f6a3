"""SGD with momentum, as the configuration's ``train`` names it
(``learning_rate``, ``momentum``).

The reference's update is the model's velocity form in plain fp32:
v = momentum * v - lr * g; w += v. The first step starts from v = 0, so
its change of the parameters is -lr * g exactly: the program's first
gradient is read from its parameters before and after that step, as
||dw|| / lr.
"""

import torch


def program(train_cfg, net):
    """The program's optimiser over ``net``."""
    from dorknet_tpu_torch import optimisers

    return optimisers.SGDMomentum(net, float(train_cfg["learning_rate"]),
                                  float(train_cfg["momentum"]))


class Reference:
    def __init__(self, train_cfg, params):
        self.lr = float(train_cfg["learning_rate"])
        self.momentum = float(train_cfg["momentum"])
        self.state = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def apply(self, params, grads):
        out = {}
        for k, w in params.items():
            v = self.state[k]
            v.mul_(self.momentum).add_(grads[k], alpha=-self.lr)
            out[k] = w + v
        return out


def first_grad_norms(train_cfg, first):
    """name -> the norm of the program's first gradient of that leaf."""
    lr = float(train_cfg["learning_rate"])
    return {k: float(torch.linalg.vector_norm(d)) / lr for k, d in first.delta.items()}
