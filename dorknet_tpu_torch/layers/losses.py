"""Softmax + cross-entropy loss layer (counterpart of
``dorknet_tpu/layers/losses.py``): the terminal layer. A test-mode network
forward returns its softmax probabilities; a train-mode one its loss,
mean(-log(p·y)), whose gradient is pinned to (p - y)/B (``ops/loss.py``)."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer
from dorknet_tpu_torch.ops.loss import softmax_cross_entropy, softmax_probs


@register_layer
class SoftmaxWithCrossEntropy(Layer):
    def __repr__(self):
        return "SoftmaxWithCrossEntropy({})".format(self.layer_name)

    def fapply_loss(self, logits, y_soft):
        """(data_loss, probs): the loss carries the gradient; the probs are
        detached."""
        return softmax_cross_entropy(logits, y_soft), softmax_probs(logits.detach())

    def load_from_h5(self, open_f):
        pass
