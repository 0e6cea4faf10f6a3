"""Softmax and the cross-entropy with the reference's exact forward value and
gradient (counterpart of ``dorknet_tpu/ops/loss.py``).

The reference computes

    p    = softmax(logits)
    loss = mean_b( -log( sum_c p[b,c] * y[b,c] ) )
    dlogits = (p - y) / B             # whatever the labels

For one-hot y the two are the textbook pair; for soft (mixup) labels they are
not consistent, and both are reproduced: the forward through -log(p·y), the
backward pinned to (p - y)/B by a ``torch.autograd.Function``.
``F.cross_entropy`` computes -Σ y log p, another value for soft labels.

The port computes -log(p·y) in log space, logsumexp(z) - logsumexp(z + log y),
which equals it in exact arithmetic and is finite where p·y underflows to 0
in fp32 (the labelled classes' logits more than about 104 below the
largest): there the reference and the JAX package read inf. Elsewhere the
two forms part by a few fp32 roundings.
"""

import torch


def softmax_probs(logits):
    """Row softmax, max-stabilised, always computed in fp32 (equal to the
    reference's raw-exp softmax in exact arithmetic)."""
    logits = logits.float()
    z = logits - logits.max(dim=1, keepdim=True).values.detach()
    e = torch.exp(z)
    return e / e.sum(dim=1, keepdim=True)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, y_soft):
        p = softmax_probs(logits)
        ctx.save_for_backward(p, y_soft)
        ctx.logits_dtype = logits.dtype
        z = logits.float()
        return torch.mean(torch.logsumexp(z, dim=1) - torch.logsumexp(z + torch.log(y_soft), dim=1))

    @staticmethod
    def backward(ctx, g):
        p, y = ctx.saved_tensors
        return (g * (p - y) / p.shape[0]).to(ctx.logits_dtype), None


def softmax_cross_entropy(logits, y_soft):
    """Mean -log(p · y) over the batch, in fp32; its gradient with respect to
    the logits is (p - y)/B. y_soft: (B, classes) fp32."""
    return _SoftmaxCrossEntropy.apply(logits, y_soft)
