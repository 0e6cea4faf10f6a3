"""Depthwise 7x7 convolution, padding 3, stride 1, over NHWC tensors, with a
hand-written weight gradient.

``Depthwise7x7Fn`` is the autograd Function that ``ops/conv.depthwise_conv2d``
sends a 7x7 / padding 3 / stride 1 layer with C a multiple of 4 through when
a gradient is needed (ConvNeXt's 18 depthwise layers):

- the forward is ``F.conv2d(groups=C)`` on the NHWC tensor's channels-last
  view, the call ``ops/conv.py`` makes for every other depthwise shape;
- dx is ``aten.convolution_backward`` with only the input's gradient asked
  for, on the same views: cuDNN's dgrad, as autograd would run it;
- dw is ``depthwise7x7_dw``, the hand-written CUDA kernel
  ``csrc/depthwise7x7_dw.cu``, in place of cuDNN's fp32 NHWC grouped weight
  gradient.

The JAX package has no kernel here (XLA takes every depthwise shape but
3x3), so nothing is ported: the kernel replaces a library call.

On a CUDA tensor ``depthwise7x7_dw`` launches the kernel, or raises; on a
CPU tensor it computes the same function with its plain PyTorch version,
``depthwise7x7_dw_plain`` (in fp64 too, for finite-difference checks).
Nothing sends a CUDA tensor to the plain version. The kernel's launches are
counted in ``depthwise7x7_dw.launches``, and by route in
``.launches_by_route`` (one route, ``"strip"``).
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.ops.cuda.bn_stats import sm_count
from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library
from dorknet_tpu_torch.ops.cuda.depthwise import sum_dtype

ROUTES = ("strip",)
K, PAD = 7, 3
_CHANNELS = 4  # C must be a multiple of this (the route's rule in ops/conv.py)


def depthwise7x7_dw_plain(x, g):
    """dw in plain PyTorch: for each of the 49 taps, the shifted window of
    the zero-padded x times g, summed over (N, H, W). x and g: (N,H,W,C).
    Returns (C,7,7) in fp32 (fp64 for fp64 inputs)."""
    N, H, W, C = g.shape
    acc_dtype = sum_dtype(x)
    xp = F.pad(x.to(acc_dtype), (0, 0, PAD, PAD, PAD, PAD))
    gf = g.to(acc_dtype)
    taps = [(xp[:, di:di + H, dj:dj + W, :] * gf).sum(dim=(0, 1, 2))
            for di in range(K) for dj in range(K)]
    return torch.stack(taps, dim=1).reshape(C, K, K)


def _check(x, g):
    if x.dim() != 4 or tuple(g.shape) != tuple(x.shape):
        raise ValueError("depthwise7x7_dw: x and g must be (N,H,W,C) of one shape, got {} "
                         "and {}".format(tuple(x.shape), tuple(g.shape)))
    if x.dtype != g.dtype or x.device != g.device:
        raise ValueError("depthwise7x7_dw: x is {} on {} but g {} on {}".format(
            x.dtype, x.device, g.dtype, g.device))
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("depthwise7x7_dw: x and g must be contiguous NHWC")
    if x.shape[3] % _CHANNELS != 0:
        raise ValueError("depthwise7x7_dw: C must be a multiple of {}, got {}".format(
            _CHANNELS, x.shape[3]))


def launch_dw(x, g):
    """The kernel on CUDA tensors (x and g already checked by ``_check``),
    which must be aligned to 4 channels (16 bytes fp32, 8 bytes bf16): the
    kernel copies 4 channels at a time. The kernel's source sets the launch
    geometry and says how many bands of partials it needs."""
    if x.device.type != "cuda":
        raise ValueError("depthwise7x7_dw: unsupported device {}".format(x.device))
    if x.dtype not in DTYPE_CODE:
        raise TypeError("depthwise7x7_dw: x and g must be float32 or bfloat16, got {}".format(
            x.dtype))
    nbytes = _CHANNELS * x.element_size()
    if x.data_ptr() % nbytes or g.data_ptr() % nbytes:
        raise ValueError("depthwise7x7_dw: x and g must be aligned to {} channels ({} "
                         "bytes)".format(_CHANNELS, nbytes))
    N, H, W, C = x.shape
    if x.numel() == 0:
        return torch.zeros((C, K, K), dtype=torch.float32, device=x.device)
    kernels = load_library()
    bands = kernels.lib.dorknet_depthwise7x7_dw_bands(N, H, C, sm_count(x.device.index))
    partials = torch.empty((bands, K * K, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((C, K, K), dtype=torch.float32, device=x.device)
    err = kernels.lib.dorknet_depthwise7x7_dw(
        x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(), N, H, W, C, bands,
        DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    check(kernels.lib, err, "depthwise7x7_dw launch")
    depthwise7x7_dw.launches += 1
    depthwise7x7_dw.launches_by_route["strip"] += 1
    return dw


def depthwise7x7_dw(x, g):
    """Gradient of the (C,7,7) filter of a depthwise 7x7 convolution with
    padding 3 and stride 1. x (the input) and g (the output's gradient):
    (N,H,W,C) contiguous, one dtype, C a multiple of 4; on the card float32
    or bfloat16 and aligned to 4 channels. Returns (C,7,7) float32, summed in
    fp32. Deterministic: the same inputs give bit-equal results."""
    _check(x, g)
    if x.device.type == "cpu":
        return depthwise7x7_dw_plain(x, g)
    return launch_dw(x, g)


depthwise7x7_dw.launches = 0
depthwise7x7_dw.launches_by_route = dict.fromkeys(ROUTES, 0)


def _nchw(t):
    """The NCHW view of an NHWC tensor (channels-last in memory)."""
    return t.permute(0, 3, 1, 2)


class Depthwise7x7Fn(torch.autograd.Function):
    """Depthwise 7x7, padding 3, stride 1: cuDNN's forward and dx, the
    hand-written dw. x: (N,H,W,C) in the compute dtype; w: (C,7,7), cast to
    x's dtype for the forward and dx. The forward and dx are the values
    autograd gives for ``F.conv2d`` on the same views; dw is fp32 summed and
    returned in w's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        w_k = w.to(x.dtype).unsqueeze(1)
        ctx.save_for_backward(x, w)
        y = F.conv2d(_nchw(x), w_k, padding=PAD, groups=w.shape[0])
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx, _, _ = torch.ops.aten.convolution_backward(
                _nchw(g), _nchw(x), w.to(x.dtype).unsqueeze(1), None, [1, 1], [PAD, PAD],
                [1, 1], False, [0, 0], w.shape[0], [True, False, False])
            dx = dx.permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = depthwise7x7_dw(x, g).to(w.dtype)
        return dx, dw

