"""Percent of the card's fp32 peak (67 TFLOP/s outside the tensor cores,
what TF32-off fp32 runs on) that the window's training work reaches: the
training FLOPs an image (3 x the forward less the first layer's input
gradient, counted from the layer shapes), times the images trained, over
the window's seconds."""

from benchmark_torch.work.peaks import FP32_FLOPS_PER_S


def read(rec):
    if rec.device.type != "cuda" or not rec.images:
        return None
    flops = rec.counters["train_flops_per_image"] * rec.images
    return 100.0 * flops / rec.window_s / FP32_FLOPS_PER_S
