"""Percent of the device time of the traced slice's operations in the class
"elementwise and reductions" (``harness/trace.kernel_class``): BN's
normalise and backward, the activations and the other elementwise passes."""

from benchmark_torch.harness.trace import ELEMENTWISE


def read(rec):
    return None if rec.slice is None else rec.slice.class_share(ELEMENTWISE)
