"""GEMM, and GEMM with the batch-norm statistics of its output columns.

One hand-written CUDA kernel, ``csrc/matmul.cu``, with its statistics
epilogue on or off, replaces the Pallas kernels of
``dorknet_tpu/ops/pallas/matmul.py``:

- ``matmul(a, b)``: (M,K) @ (K,N) with fp32 accumulation and an fp32 result;
- ``matmul_bn_stats(a, b, out_dtype=None)``: the same product, returned in
  ``out_dtype`` (default a's), with the mean and biased variance of each
  column of the fp32 product, taken before it is rounded to ``out_dtype``.

They take the JAX package's (K, N) layout for b (the port's pointwise weight
is (O, C): pass its contiguous transpose). The TPU tiling arguments ``bm``,
``bn`` and ``interpret`` have no counterpart. The port's pointwise and dense
layers compute their products with ``torch.matmul``, as the JAX package's do
with ``jnp.dot`` outside any Pallas kernel; these two serve the BN-fusion A/B
(``utils/bn_fuse_ab.py``).

On CUDA tensors each wrapper launches the kernel, or raises; on CPU tensors
it computes the same function with its plain PyTorch version (``*_plain``).
Launches are counted in ``.launches``.
"""

import torch

from dorknet_tpu_torch.ops.cuda.build import check, load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE_M = 128  # rows of y a block owns (csrc/matmul.cu MM_BM)


def _validate(a, b, out_dtype, who):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("{}: a must be (M,K) and b (K,N), got {} and {}".format(
            who, tuple(a.shape), tuple(b.shape)))
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError("{}: a and b must both be float32 or both bfloat16, got {} and "
                        "{}".format(who, a.dtype, b.dtype))
    if out_dtype not in _DTYPE_CODE:
        raise TypeError("{}: out_dtype must be float32 or bfloat16, got {}".format(
            who, out_dtype))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("{}: a and b must be contiguous (b is (K,N): pass a "
                         "contiguous transpose of an (N,K) weight)".format(who))
    if a.device != b.device:
        raise ValueError("{}: a on {} but b on {}".format(who, a.device, b.device))
    if max(a.shape[0], a.shape[1], b.shape[1]) >= 2 ** 31:
        raise ValueError("{}: dimensions must be below 2^31".format(who))


def matmul_plain(a, b):
    """a @ b in fp32, in plain PyTorch (on the card that is cuBLAS in fp32:
    the port keeps TF32 off)."""
    return a.float() @ b.float()


def matmul_bn_stats_plain(a, b, out_dtype=None):
    """The fused function in plain PyTorch: the fp32 product, its column
    mean and mean(y²) − mean², clamped at 0, then y cast to out_dtype."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    y = matmul_plain(a, b)
    mean = y.mean(dim=0)
    var = torch.clamp((y * y).mean(dim=0) - mean * mean, min=0.0)
    return y.to(out_dtype), mean, var


def _launch(a, b, out_dtype, stats):
    """The kernel on CUDA tensors: returns y, or (y, mean, var) with
    stats."""
    if a.device.type != "cuda":
        raise ValueError("matmul: unsupported device {}".format(a.device))
    M, K = a.shape
    N = b.shape[1]
    y = torch.empty((M, N), dtype=out_dtype, device=a.device)
    mean = var = partials = None
    if stats:
        partials = torch.empty((-(-M // TILE_M), 2, N), dtype=torch.float32,
                               device=a.device)
        mean, var = torch.empty((2, N), dtype=torch.float32, device=a.device)
    if M and N:
        kernels = load_library()
        err = kernels.lib.dorknet_matmul(
            a.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if var is None else var.data_ptr(),
            M, K, N, _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], int(stats),
            torch.cuda.current_stream(a.device).cuda_stream, a.device.index)
        check(kernels.lib, err, "matmul launch")
    return (y, mean, var) if stats else y


def matmul(a, b):
    """(M,K) @ (K,N) -> (M,N) float32. a and b contiguous, both float32 or
    both bfloat16, summed in fp32."""
    _validate(a, b, torch.float32, "matmul")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    y = _launch(a, b, torch.float32, stats=False)
    if y.numel():
        matmul.launches += 1
    return y


def matmul_bn_stats(a, b, out_dtype=None):
    """(M,K) @ (K,N) with per-column batch-norm statistics. Returns (y, mean,
    var): y (M,N) in ``out_dtype`` (default a's dtype), mean and the biased
    variance (N,) float32 over the M rows of the fp32 product, var clamped
    at 0. M must be positive. Deterministic: the same inputs give bit-equal
    results."""
    out_dtype = a.dtype if out_dtype is None else out_dtype
    _validate(a, b, out_dtype, "matmul_bn_stats")
    if a.shape[0] == 0 or b.shape[1] == 0:
        raise ValueError("matmul_bn_stats: statistics need rows and columns, got {} @ "
                         "{}".format(tuple(a.shape), tuple(b.shape)))
    if a.device.type == "cpu":
        return matmul_bn_stats_plain(a, b, out_dtype)
    out = _launch(a, b, out_dtype, stats=True)
    matmul_bn_stats.launches += 1
    return out


matmul.launches = 0
matmul_bn_stats.launches = 0
