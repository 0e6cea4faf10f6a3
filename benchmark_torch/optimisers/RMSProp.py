"""RMSProp, as the configuration's ``train`` names it (``learning_rate``,
``decay_rate``).

The reference's update is the model's accumulator form in plain fp32:
c = d * c + (1 - d) * g^2; w -= lr * g / sqrt(c + 1e-5). The first step's
change of the parameters is near lr * sign(g), which does not give g back,
so the program's first gradient is read from its optimiser state after that
step, as the program's checkpoint holds it (``opt_cache`` of
``utils.torch_io.state_tree``): c = (1 - d) * g^2, so ||g|| is
sqrt(sum(c) / (1 - d)).
"""

import torch


def program(train_cfg, net):
    """The program's optimiser over ``net``."""
    from dorknet_tpu_torch import optimisers

    return optimisers.RMSProp(net, float(train_cfg["learning_rate"]),
                              float(train_cfg["decay_rate"]))


class Reference:
    def __init__(self, train_cfg, params):
        self.lr = float(train_cfg["learning_rate"])
        self.decay = float(train_cfg["decay_rate"])
        self.state = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def apply(self, params, grads):
        out = {}
        for k, w in params.items():
            g, c = grads[k], self.state[k]
            c.mul_(self.decay).add_(g * g, alpha=1.0 - self.decay)
            out[k] = w - self.lr * g / torch.sqrt(c + 1e-5)
        return out


def first_grad_norms(train_cfg, first):
    """name -> the norm of the program's first gradient of that leaf."""
    d = float(train_cfg["decay_rate"])
    return {k: float(torch.sqrt(torch.sum(c.double()) / (1.0 - d)))
            for k, c in first.opt_cache().items()}
