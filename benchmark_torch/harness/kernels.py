"""Device time of the port's kernels at a cell's shapes, for the roofline
readers. Each pass calls the port's public op at the layer shapes the
reference's layer table gives, so it reads the same work whatever kernel
implements the op. On the CPU there is no device time: each returns None."""

import torch

from benchmark_torch.harness.timing import device_ms
from benchmark_torch.work import counts


def _randn(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def dw3x3_ms(shapes, device, backward):
    """(device ms, bound ms) of one forward (and with ``backward`` one dx
    and one dw) of every 3x3 depthwise layer (N, H, W, C, stride), fp32."""
    if device.type != "cuda" or not shapes:
        return None
    from dorknet_tpu_torch.ops.conv import depthwise_conv2d

    gen = torch.Generator(device=device).manual_seed(7)
    fwd, bwd, bound = [], [], 0.0
    for N, H, W, C, s in shapes:
        x = _randn((N, H, W, C), gen, device)
        w = _randn((C, 3, 3), gen, device) / 3.0
        fwd.append(lambda x=x, w=w, s=s: depthwise_conv2d(x, w, stride=s, padding=1))
        bound += counts.dw_bound_ms(N, H, W, C, s)
        if backward:
            x, w = x.requires_grad_(), w.requires_grad_()
            with torch.enable_grad():
                y = depthwise_conv2d(x, w, stride=s, padding=1)
            g = torch.randn_like(y)
            bwd.append(lambda y=y, x=x, w=w, g=g: torch.autograd.grad(
                y, (x, w), g, retain_graph=True))
            bound += 2 * counts.dw_bound_ms(N, H, W, C, s)
    with torch.no_grad():
        ms = device_ms(fwd, inner=1)
    if backward:
        ms += device_ms(bwd, inner=1)
    return ms, bound


def bn_stats_ms(shapes, device):
    """(device ms, bound ms) of ``batch_norm_stats`` over every 4-D batch
    norm input (N, H, W, C), fp32."""
    if device.type != "cuda" or not shapes:
        return None
    from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats

    gen = torch.Generator(device=device).manual_seed(8)
    xs = [_randn(s, gen, device) for s in shapes]
    ms = device_ms([lambda x=x: batch_norm_stats(x) for x in xs], inner=1)
    return ms, sum(counts.bn_stats_bound_ms(*s) for s in shapes)


def augment_ms(call, bound_ms, device):
    """(device ms, bound ms) of one augmentation call."""
    if device.type != "cuda" or call is None:
        return None
    return device_ms([call]), bound_ms


def share(pair):
    """Percent of the bound that a (device ms, bound ms) pair reaches."""
    if pair is None:
        return None
    ms, bound = pair
    return 100.0 * bound / ms
