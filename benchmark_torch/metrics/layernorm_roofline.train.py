"""Percent of a bytes bound that the port's ``ops.norm.layer_norm`` reaches
over one forward and one backward (dx, dgamma and dbeta) of each of the
cell's LayerNorms ("ln" rows of the layer table), at the trained batch and
each one's layout: NHWC for a 4-D input, (N, C) rows for a 2-D one. Timed
by ``harness.timing.device_ms``.

The bound, kept here: fp32, each element of x read once and y written once
in the forward, 8 B; x and dy read and dx written once in the backward, 12
B; gamma, beta, their gradients and the per-row statistics left out (C or
fewer values against N H W C); at 3.35 TB/s (``work/peaks``). ConvNeXt-T at
batch 128: 381 million elements over its 23 LayerNorms, 7.6 GB, 2.27 ms.
A program without ``layer_norm`` reads nothing."""

import math

import torch

from benchmark_torch.harness.timing import device_ms
from benchmark_torch.work.peaks import HBM_BYTES_PER_S

FWD_BYTES, BWD_BYTES = 8, 12  # a fp32 element's bytes of traffic


def bound_ms(elements):
    """The least time of one forward and one backward over ``elements``."""
    return (FWD_BYTES + BWD_BYTES) * elements / HBM_BYTES_PER_S * 1e3


def read(rec):
    shapes = [l["x"] for l in rec.layers if l["op"] == "ln"]
    if rec.device.type != "cuda" or not shapes:
        return None
    try:
        from dorknet_tpu_torch.ops.norm import layer_norm
    except ImportError:
        return None

    gen = torch.Generator(device=rec.device).manual_seed(11)
    fwd, bwd, elements = [], [], 0
    for shape in shapes:
        C = shape[1]
        x = torch.randn((shape[0],) + tuple(shape[2:]) + (C,), generator=gen,
                        device=rec.device).requires_grad_()
        gamma = torch.ones(C, device=rec.device, requires_grad=True)
        beta = torch.zeros(C, device=rec.device, requires_grad=True)
        fwd.append(lambda x=x, gamma=gamma, beta=beta: layer_norm(x, gamma, beta))
        with torch.enable_grad():
            y = layer_norm(x, gamma, beta)
        g = torch.randn_like(y)
        bwd.append(lambda y=y, x=x, gamma=gamma, beta=beta, g=g: torch.autograd.grad(
            y, (x, gamma, beta), g, retain_graph=True))
        elements += math.prod(shape)
    with torch.no_grad():
        ms = device_ms(fwd, inner=1)
    ms += device_ms(bwd, inner=1)
    return 100.0 * bound_ms(elements) / ms
