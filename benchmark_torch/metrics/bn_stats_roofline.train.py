"""Percent of the bound (one fp32 read of x at 3.35 TB/s) that the port's
``batch_norm_stats`` reaches over the cell's 4-D batch norms at the trained
batch, by device ms."""

from benchmark_torch.harness import kernels
from benchmark_torch.work import counts


def read(rec):
    return kernels.share(kernels.bn_stats_ms(counts.bn_layers(rec.layers), rec.device))
