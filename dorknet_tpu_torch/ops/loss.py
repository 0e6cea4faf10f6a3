"""Softmax (counterpart of ``dorknet_tpu/ops/loss.py``). The cross-entropy
with the reference's pinned (p - y)/B gradient comes with the training slice."""

import torch


def softmax_probs(logits):
    """Row softmax, max-stabilised, always computed in fp32 (equal to the
    reference's raw-exp softmax in exact arithmetic)."""
    logits = logits.float()
    z = logits - logits.max(dim=1, keepdim=True).values.detach()
    e = torch.exp(z)
    return e / e.sum(dim=1, keepdim=True)
