"""Percent of the card's fp32 peak that the window's served forwards reach:
the forward FLOPs an image, counted from the layer shapes, times the images
served, over the window's seconds."""

from benchmark_torch.work.peaks import FP32_FLOPS_PER_S


def read(rec):
    if rec.device.type != "cuda" or not rec.images:
        return None
    flops = rec.counters["forward_flops_per_image"] * rec.images
    return 100.0 * flops / rec.window_s / FP32_FLOPS_PER_S
