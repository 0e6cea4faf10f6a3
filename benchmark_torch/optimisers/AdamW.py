"""AdamW, as the configuration's ``train`` names it (``learning_rate``,
``beta1``, ``beta2``, ``eps``, ``weight_decay``).

The reference's update is ``torch.optim.AdamW``'s arithmetic in plain fp32:
w -= lr * wd * w on the leaves with two or more axes longer than one (the
weights; biases, LayerNorm gains and offsets and layer scales are not
decayed, as ConvNeXt's ``optim_factory`` skips 1-D leaves); m = b1 * m +
(1 - b1) * g; v = b2 * v + (1 - b2) * g^2; w -= lr / (1 - b1^t) * m /
(sqrt(v) / sqrt(1 - b2^t) + eps). Adam's first change of the parameters is
near lr * sign(g), which does not give g back, so the program's first
gradient is read from its optimiser state after that step, as the
program's checkpoint holds it (``opt_cache`` of
``utils.torch_io.state_tree``): the first moments come first, in the
parameters' order, and after one step m = (1 - b1) * g, so ||g|| is
||m|| / (1 - b1).
"""

import torch


def program(train_cfg, net):
    """The program's optimiser over ``net``."""
    from dorknet_tpu_torch import optimisers

    return optimisers.AdamW(net, float(train_cfg["learning_rate"]), float(train_cfg["beta1"]),
                            float(train_cfg["beta2"]), float(train_cfg["eps"]),
                            float(train_cfg["weight_decay"]))


def _decayed(w):
    return sum(n > 1 for n in w.shape) >= 2


class Reference:
    def __init__(self, train_cfg, params):
        self.lr = float(train_cfg["learning_rate"])
        self.b1, self.b2 = float(train_cfg["beta1"]), float(train_cfg["beta2"])
        self.eps, self.wd = float(train_cfg["eps"]), float(train_cfg["weight_decay"])
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def apply(self, params, grads):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        out = {}
        for k, w in params.items():
            g, m, v = grads[k], self.m[k], self.v[k]
            if _decayed(w):
                w = w * (1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            out[k] = w - (self.lr / c1) * m / (torch.sqrt(v) / c2 ** 0.5 + self.eps)
        return out


def first_grad_norms(train_cfg, first):
    """name -> the norm of the program's first gradient of that leaf."""
    b1 = float(train_cfg["beta1"])
    return {k: float(torch.linalg.vector_norm(m.double())) / (1.0 - b1)
            for k, m in first.opt_cache().items()}
