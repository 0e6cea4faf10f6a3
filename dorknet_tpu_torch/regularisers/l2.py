"""L2 weight regulariser (counterpart of ``dorknet_tpu/regularisers/l2.py``).

Metadata only in this slice: its type and strength appear in layer ``repr``s
and in the h5 attrs. The loss term and gradient come with the training slice.
"""


class l2:
    def __init__(self, strength=0.005):
        self.type = "l2"
        self.strength = strength

    def __repr__(self):
        return "l2(strength={})".format(self.strength)
