"""Batch-norm statistics: per-channel mean and biased variance over (..., C).

The hand-written CUDA kernel ``csrc/bn_stats.cu`` replaces the Pallas kernel
``dorknet_tpu/ops/pallas/bn_stats.py:batch_norm_stats``: one read of x, fp32
sums, E[x²]−E[x]² clamped at 0, in two deterministic passes. Every train-mode
batch norm takes its statistics from it (``ops/norm.py``).

On a CUDA tensor ``batch_norm_stats`` launches the kernel, or raises; on a
CPU tensor it computes the same function with its plain PyTorch version,
``batch_norm_stats_plain``. Its launches are counted in ``.launches``.
"""

import functools

import torch

from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library


# pass 1 aims at this many blocks per SM, with bands of MIN_BAND..MAX_BAND
# rows (a thread's serial run is a band over its 8 lanes)
_BLOCKS_PER_SM = 8
MIN_BAND, MAX_BAND = 64, 2048
_MAX_BANDS = 65535


def _check(x):
    if x.dim() < 1 or x.shape[-1] == 0 or x.numel() == 0:
        raise ValueError("batch_norm_stats: x must be (..., C) with rows and channels, "
                         "got shape {}".format(tuple(x.shape)))
    if x.dtype not in DTYPE_CODE:
        raise TypeError("batch_norm_stats: x must be float32 or bfloat16, got {}".format(
            x.dtype))
    if not x.is_contiguous():
        raise ValueError("batch_norm_stats: x must be contiguous")


def batch_norm_stats_plain(x):
    """The statistics in plain PyTorch: fp32 mean over every axis but the
    last, and mean(x²) − mean², clamped at 0. Returns (mean, var), (C,)
    fp32."""
    dims = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean, min=0.0)
    return mean, var


def stats_bands(M, C, sms):
    """How many row bands pass 1 splits the M rows into: about
    ``_BLOCKS_PER_SM`` blocks per SM over the channel tiles, bands of at
    least ``MIN_BAND`` and at most ``MAX_BAND`` rows (as far as 65535 bands
    allow), never more bands than rows."""
    tiles = -(-C // 32)
    want = min(-(-_BLOCKS_PER_SM * sms // tiles), -(-M // MIN_BAND))
    return max(1, min(max(want, -(-M // MAX_BAND)), _MAX_BANDS, M))


@functools.cache
def sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def batch_norm_stats(x):
    """x: (..., C) contiguous, float32 or bfloat16. Returns (mean, var), each
    (C,) float32: the mean and the biased variance of every channel over all
    the other axes, accumulated in fp32, var = E[x²]−E[x]² clamped at 0.
    Deterministic: the same input gives bit-equal results."""
    _check(x)
    if x.device.type == "cpu":
        return batch_norm_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError("batch_norm_stats: unsupported device {}".format(x.device))
    C = x.shape[-1]
    M = x.numel() // C
    P = stats_bands(M, C, sm_count(x.device.index))
    partials = torch.empty((P, 2, C), dtype=torch.float32, device=x.device)
    mean, var = torch.empty((2, C), dtype=torch.float32, device=x.device)
    kernels = load_library()
    err = kernels.lib.dorknet_bn_stats(
        x.data_ptr(), partials.data_ptr(), mean.data_ptr(), var.data_ptr(), M, C, P,
        DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        x.device.index)
    check(kernels.lib, err, "batch_norm_stats launch")
    batch_norm_stats.launches += 1
    return mean, var


batch_norm_stats.launches = 0
