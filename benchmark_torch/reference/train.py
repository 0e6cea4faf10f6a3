"""The reference training step: forward, loss and gradients in plain fp32
PyTorch on the executor of ``plain.py``; each optimiser's update is its
``Reference`` in ``optimisers/<name>.py``.

The loss is the model's: the reported value is mean(-log(p . y)) plus the
reported l2 terms, and the gradient is that of the soft-label cross-entropy
-sum(y log p) plus every l2 term, whose gradient with respect to the logits
is (p - y) / B for labels that sum to 1 (mixup's do).
"""

import torch
import torch.nn.functional as F

from benchmark_torch.reference.plain import Executor


def step(forward, cfg, params, stats, x, y):
    """One forward and backward at ``params`` (name -> tensor) and running
    ``stats`` (name -> (mean, std)). Returns (reported loss, {name: grad},
    new stats)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    ex = Executor("train", leaves, dict(stats))
    logits = forward(ex, x, cfg)
    reported_reg, full_reg = ex.reg_terms()
    p = torch.softmax(logits, dim=1)
    reported = torch.mean(-torch.log(torch.sum(p * y, dim=1))) + reported_reg
    objective = F.cross_entropy(logits, y) + full_reg
    names = list(leaves)
    grads = torch.autograd.grad(objective, [leaves[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in zip(names, grads)}
    return float(reported.detach()), grads, ex.stats

