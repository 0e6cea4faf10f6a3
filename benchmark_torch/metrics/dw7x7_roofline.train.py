"""Percent of the bound that the port's depthwise op reaches over one
forward, dx and dw of each of the cell's 7x7 depthwise layers (padding 3),
at the trained batch: the bound (bytes at 3.35 TB/s, or 2 x 49 flops an
output element at 67 TFLOP/s, whichever is longer, three times a layer:
``work/counts.dw_bound_ms(..., k=7)``) over the device ms of a pass through
``ops.conv.depthwise_conv2d`` and its backward, timed by
``harness.timing.device_ms``. The result reads the same work whatever
implements the op."""

import torch

from benchmark_torch.harness.timing import device_ms
from benchmark_torch.work import counts


def read(rec):
    shapes = [(l["x"][0], l["x"][2], l["x"][3], l["x"][1], l["stride"])
              for l in rec.layers if l["op"] == "dw" and l["k"] == 7]
    if rec.device.type != "cuda" or not shapes:
        return None
    from dorknet_tpu_torch.ops.conv import depthwise_conv2d

    gen = torch.Generator(device=rec.device).manual_seed(10)
    fwd, bwd, bound = [], [], 0.0
    for N, H, W, C, s in shapes:
        x = torch.randn((N, H, W, C), generator=gen, device=rec.device).requires_grad_()
        w = (torch.randn((C, 7, 7), generator=gen, device=rec.device) / 7.0).requires_grad_()
        fwd.append(lambda x=x, w=w, s=s: depthwise_conv2d(x, w, stride=s, padding=3))
        with torch.enable_grad():
            y = depthwise_conv2d(x, w, stride=s, padding=3)
        g = torch.randn_like(y)
        bwd.append(lambda y=y, x=x, w=w, g=g: torch.autograd.grad(y, (x, w), g,
                                                                   retain_graph=True))
        bound += 3 * counts.dw_bound_ms(N, H, W, C, s, k=7)
    with torch.no_grad():
        ms = device_ms(fwd, inner=1)
    ms += device_ms(bwd, inner=1)
    return 100.0 * bound / ms
