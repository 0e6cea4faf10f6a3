"""Percent of the fp32 FLOP bound (``work/peaks.FP32_FLOPS_PER_S``, what
TF32-off fp32 runs on) that the port's dense (k > 1) and pointwise
convolutions reach over one forward, input gradient and weight gradient of
each such layer of the cell's layer table, at the trained batch.

Each layer is timed through the port's public ops (``ops.conv.conv2d``,
``ops.conv.pointwise_conv2d``) and autograd by ``harness.timing.device_ms``,
so the share reads the same work whatever implements it. The bound is 3 x
``work/counts.layer_flops`` of those layers, less the first layer's input
gradient, which no step computes (the images need no gradient). The layers
are timed in turn, each one's tensors freed before the next is made, so
that the reader holds one layer's activations beside the live program."""

import math

import torch

from benchmark_torch.harness.timing import device_ms
from benchmark_torch.work import counts
from benchmark_torch.work.peaks import FP32_FLOPS_PER_S


def _padding(layer):
    """The least zero padding that gives the table's output size."""
    H, P, k, s = layer["x"][2], layer["y"][2], layer["k"], layer["stride"]
    return max(0, math.ceil(((P - 1) * s + k - H) / 2))


def _layer_ms(layer, first, gen, device):
    """Device ms of one forward and one backward of ``layer``."""
    from dorknet_tpu_torch.ops.conv import conv2d, pointwise_conv2d

    N, C, H, W = layer["x"]
    O, s = layer["y"][1], layer["stride"]
    x = torch.randn((N, H, W, C), generator=gen, device=device)
    if layer["op"] == "conv":
        k, pad = layer["k"], _padding(layer)
        w = torch.randn((O, C, k, k), generator=gen, device=device) / math.sqrt(C * k * k)

        def op(x, w):
            return conv2d(x, w, stride=s, padding=pad)
    else:
        w = torch.randn((O, C), generator=gen, device=device) / math.sqrt(C)

        def op(x, w):
            return pointwise_conv2d(x, w, stride=s)
    with torch.no_grad():
        ms = device_ms([lambda: op(x, w)], inner=1)
    leaves = (w.requires_grad_(),) if first else (x.requires_grad_(), w.requires_grad_())
    with torch.enable_grad():
        y = op(x, w)
    if tuple(y.shape) != (N, layer["y"][2], layer["y"][3], O):
        raise ValueError("{}: the op gives {}, the table {}".format(
            layer["name"], tuple(y.shape), layer["y"]))
    g = torch.randn_like(y)
    ms += device_ms([lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)], inner=1)
    return ms


def read(rec):
    if rec.device.type != "cuda":
        return None
    layers = [l for l in rec.layers if l["op"] == "pw" or (l["op"] == "conv" and l["k"] > 1)]
    if not layers:
        return None
    first = next(l for l in rec.layers if counts.layer_flops(l))
    gen = torch.Generator(device=rec.device).manual_seed(9)
    ms = flops = 0.0
    for layer in layers:
        ms += _layer_ms(layer, layer is first, gen, rec.device)
        flops += (2 if layer is first else 3) * counts.layer_flops(layer)
        torch.cuda.empty_cache()
    return 100.0 * flops / FP32_FLOPS_PER_S * 1e3 / ms
