"""Percent of the bound (``work/counts.augment_bound_ms``) that one call of
the port's fused augmentation reaches at the cell's rows and sizes, by
device ms."""

from benchmark_torch.harness import kernels


def read(rec):
    return kernels.share(kernels.augment_ms(rec.handles.get("augment"),
                                            rec.handles.get("augment_bound_ms"), rec.device))
