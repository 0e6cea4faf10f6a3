"""Depthwise 3x3 convolution (padding 1, stride 1 or 2) over NHWC tensors.

``depthwise3x3`` is the wrapper of the hand-written CUDA kernel in
``csrc/depthwise3x3.cu``, which replaces the Pallas kernel
``dorknet_tpu/ops/pallas/depthwise.py:depthwise3x3``. On a CUDA tensor it
launches the kernel, or raises; on a CPU tensor it computes the same function
with ``depthwise3x3_plain``. Nothing sends a CUDA tensor to the plain version.

The kernel has no backward yet: the training slice wraps the backward
kernels in a ``torch.autograd.Function``.
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.ops.cuda.build import check, load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _out_hw(H, W, stride):
    return (H - 1) // stride + 1, (W - 1) // stride + 1


def _validate(x, w, stride):
    if stride not in (1, 2):
        raise ValueError("depthwise3x3: stride must be 1 or 2, got {}".format(stride))
    if x.dim() != 4:
        raise ValueError("depthwise3x3: x must be (N,H,W,C), got shape {}".format(
            tuple(x.shape)))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("depthwise3x3: x must be float32 or bfloat16, got {}".format(
            x.dtype))
    if not x.is_contiguous():
        raise ValueError("depthwise3x3: x must be contiguous NHWC")
    C = x.shape[3]
    if tuple(w.shape) != (C, 3, 3) or w.dtype != torch.float32:
        raise ValueError("depthwise3x3: w must be float32 ({}, 3, 3), got {} {}".format(
            C, w.dtype, tuple(w.shape)))
    if not w.is_contiguous():
        raise ValueError("depthwise3x3: w must be contiguous")
    if w.device != x.device:
        raise ValueError("depthwise3x3: x on {} but w on {}".format(x.device, w.device))


def depthwise3x3_plain(x, w, stride):
    """The same function in plain PyTorch: pad 1, then nine shifted and
    strided slices times the weights, summed in fp32, cast back to x's
    dtype. x: (N,H,W,C); w: (C,3,3) fp32."""
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, stride)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N, Ho, Wo, C), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + stride * (Ho - 1) + 1:stride,
                     dj:dj + stride * (Wo - 1) + 1:stride, :]
            acc = acc + tap * w[:, di, dj]
    return acc.to(x.dtype)


def depthwise3x3(x, w, stride=1):
    """Depthwise 3x3, padding 1, stride 1 or 2. x: (N,H,W,C) contiguous,
    float32 or bfloat16; w: (C,3,3) float32. Returns (N,Ho,Wo,C) in x's dtype,
    accumulated in fp32. Bias is the caller's."""
    _validate(x, w, stride)
    if x.device.type == "cpu":
        return depthwise3x3_plain(x, w, stride)
    if x.device.type != "cuda":
        raise ValueError("depthwise3x3: unsupported device {}".format(x.device))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "depthwise3x3 has no CUDA backward yet; it comes with the training "
            "slice. Run the forward under torch.inference_mode() or no_grad().")
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, stride)
    y = torch.empty((N, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    kernels = load_library()
    err = kernels.lib.dorknet_depthwise3x3_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, stride,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        x.device.index)
    check(kernels.lib, err, "depthwise3x3 launch")
    depthwise3x3.launches += 1
    return y


depthwise3x3.launches = 0
