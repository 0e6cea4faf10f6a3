"""Percent of the bound that the port's 3x3 depthwise op reaches over one
forward, dx and dw of each of the cell's 3x3 depthwise layers, at the
trained batch: the bound (bytes at 3.35 TB/s, ``work/counts.dw_bound_ms``)
over the device ms of a pass through ``ops.conv.depthwise_conv2d`` and its
backward (``harness/kernels.dw3x3_ms``)."""

from benchmark_torch.harness import kernels
from benchmark_torch.work import counts


def read(rec):
    return kernels.share(kernels.dw3x3_ms(counts.dw3x3_layers(rec.layers), rec.device,
                                          backward=True))
