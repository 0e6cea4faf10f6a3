"""Percent of the bound that the port's 3x3 depthwise forward reaches over
the cell's 3x3 depthwise layers at the served batch (as
``dw3x3_roofline.train``, forward only)."""

from benchmark_torch.harness import kernels
from benchmark_torch.work import counts


def read(rec):
    return kernels.share(kernels.dw3x3_ms(counts.dw3x3_layers(rec.layers), rec.device,
                                          backward=False))
