"""Softmax + cross-entropy loss layer (counterpart of
``dorknet_tpu/layers/losses.py``). In this slice it is the terminal layer
that makes the network's test-mode forward return softmax probabilities; the
loss and its pinned (p - y)/B gradient come with the training slice."""

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.layers.registry import register_layer


@register_layer
class SoftmaxWithCrossEntropy(Layer):
    def __repr__(self):
        return "SoftmaxWithCrossEntropy({})".format(self.layer_name)

    def load_from_h5(self, open_f):
        pass
