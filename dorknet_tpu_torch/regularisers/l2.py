"""L2 weight regulariser (counterpart of ``dorknet_tpu/regularisers/l2.py``):
the loss term 0.5·s·Σw² and its gradient s·w. The network adds every
layer's term to the differentiated objective, so autograd applies s·w;
``backward`` states the same gradient in closed form."""

import torch


class l2:
    def __init__(self, strength=0.005):
        self.type = "l2"
        self.strength = strength

    def __repr__(self):
        return "l2(strength={})".format(self.strength)

    def forward(self, X):
        return 0.5 * self.strength * torch.sum(torch.square(X))

    def backward(self, X):
        return self.strength * X
