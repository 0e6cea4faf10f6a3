"""GEMM, and GEMM with the batch-norm statistics of its output columns.

Hand-written CUDA kernels with a statistics epilogue on or off replace the
Pallas kernels of ``dorknet_tpu/ops/pallas/matmul.py``:

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

Three routes, chosen by shape and alignment before the launch
(``_gemm_route``):

- ``"tensor_core"`` (``csrc/matmul_sm90.cu``): bf16 a and b, K and N
  multiples of 8 (TMA's 16-byte row strides), K > 0, both base pointers
  16-byte aligned; TMA loads and ``wgmma`` on Hopper's tensor cores;
- ``"cuda_core_pipelined"`` (``csrc/matmul.cu``): fp32 a and b, K > 0, K and
  N multiples of 4, both base pointers 16-byte aligned; 16-byte ``cp.async``
  copies into a ring of three chunks of K, in 64 x 64 tiles (128 x 64 with
  the statistics, ``_gemm_tile``).
  fp32's only way to the tensor cores is TF32, which the port keeps off;
- ``"cuda_core"`` (``csrc/matmul.cu``): everything else (ragged K or N,
  misaligned views, bf16 that TMA cannot read), in 128 x 128 tiles.

The two CUDA-core routes give bit-equal y: each element is one fmaf chain
over k in order, whatever the tiling.

On CUDA tensors each wrapper launches the kernel of its route, or raises; on
CPU tensors it computes the same function with its plain PyTorch version
(``*_plain``). Launches are counted in ``.launches``, and per route in
``.launches_by_route``.
"""

import torch

from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library

# their codes at the C entry point: 0, 1, 2
ROUTES = ("cuda_core", "tensor_core", "cuda_core_pipelined")
# (BM, BN) of a block's tile of y: routes 0 and 1 have one (csrc/matmul.cu
# MM_BM x MM_BN, matmul_sm90.cu TC_BM x TC_BN)
FIXED_TILE = (128, 128)
# the pipelined route's instances, as _gemm_tile picks them: without and
# with the statistics
PIPELINED_TILES = ((64, 64), (128, 64))

def _validate(a, b, out_dtype, who):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("{}: a must be (M,K) and b (K,N), got {} and {}".format(
            who, tuple(a.shape), tuple(b.shape)))
    if a.dtype not in DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError("{}: a and b must both be float32 or both bfloat16, got {} and "
                        "{}".format(who, a.dtype, b.dtype))
    if out_dtype not in DTYPE_CODE:
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


def _gemm_route(a, b):
    """The route a (M,K) @ (K,N) takes: ``"tensor_core"`` for bf16 inputs
    that TMA can read (K > 0, K and N multiples of 8, 16-byte aligned
    pointers), ``"cuda_core_pipelined"`` for fp32 inputs that 16-byte copies
    can read (K > 0, K and N multiples of 4, 16-byte aligned pointers),
    ``"cuda_core"`` for everything else."""
    K, N = b.shape
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and K > 0
    if a.dtype == b.dtype == torch.bfloat16 and aligned and K % 8 == 0 and N % 8 == 0:
        return "tensor_core"
    if a.dtype == b.dtype == torch.float32 and aligned and K % 4 == 0 and N % 4 == 0:
        return "cuda_core_pipelined"
    return "cuda_core"


def _gemm_tile(M, K, N, stats=False):
    """(BM, BN) of the pipelined route's tile for an (M,K) @ (K,N): 64 x 64
    for ``matmul``, 128 x 64 for ``matmul_bn_stats``. Both are 64 columns
    wide, so N = 64 masks no column. Without statistics the 64-row tile
    gives the most blocks and, on an H100, was the fastest tile at every
    fp32 GEMM of the flagship; with them it doubles the partials that the
    fixed-order finishing pass sums (3,136 a column at 200,704 rows), which
    costs more than the smaller tile saves. K does not enter: every tile
    loops over all of it."""
    return (128, 64) if stats else (64, 64)


def _route_tile(route, M, K, N, stats):
    """(BM, BN) of a block's tile of y on ``route`` by default."""
    return _gemm_tile(M, K, N, stats) if route == "cuda_core_pipelined" else FIXED_TILE


def partials_shape(route, M, K, N, tile=None):
    """The statistics epilogue's scratch on ``route``: one (2, N) partial
    (column sums and sums of squares) per BM rows of y."""
    return (-(-M // (tile or _route_tile(route, M, K, N, True))[0]), 2, N)


def _launch(a, b, out_dtype, stats, route, tile=None):
    """The kernel of ``route`` on CUDA tensors, in ``tile`` (the route's
    default where None): returns y, or (y, mean, var) with stats. The C side
    refuses a route or a tile the inputs cannot take."""
    if a.device.type != "cuda":
        raise ValueError("matmul: unsupported device {}".format(a.device))
    M, K = a.shape
    N = b.shape[1]
    tile = tile or _route_tile(route, M, K, N, stats)
    y = torch.empty((M, N), dtype=out_dtype, device=a.device)
    mean = var = partials = None
    if stats:
        partials = torch.empty(partials_shape(route, M, K, N, tile), dtype=torch.float32,
                               device=a.device)
        mean, var = torch.empty((2, N), dtype=torch.float32, device=a.device)
    if M and N:
        bm, bn = tile
        kernels = load_library()
        err = kernels.lib.dorknet_matmul(
            a.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if var is None else var.data_ptr(),
            M, K, N, DTYPE_CODE[a.dtype], DTYPE_CODE[out_dtype], int(stats),
            ROUTES.index(route), bm, bn, torch.cuda.current_stream(a.device).cuda_stream,
            a.device.index)
        check(kernels.lib, err, "matmul launch ({} route)".format(route))
    return (y, mean, var) if stats else y


def launch_matmul(a, b, route, tile=None):
    """``matmul`` on CUDA tensors (already checked) through the given route
    (and, on the pipelined route, tile); ``matmul`` itself takes
    ``_gemm_route(a, b)``. For holding one route against another on the same
    inputs."""
    y = _launch(a, b, torch.float32, False, route, tile)
    if y.numel():
        matmul.launches += 1
        matmul.launches_by_route[route] += 1
    return y


def launch_matmul_bn_stats(a, b, out_dtype, route, tile=None):
    """``matmul_bn_stats`` on CUDA tensors (already checked) through the
    given route (and tile)."""
    out = _launch(a, b, out_dtype, True, route, tile)
    matmul_bn_stats.launches += 1
    matmul_bn_stats.launches_by_route[route] += 1
    return out


def matmul(a, b):
    """(M,K) @ (K,N) -> (M,N) float32. a and b contiguous, both float32 or
    both bfloat16, summed in fp32."""
    _validate(a, b, torch.float32, "matmul")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return launch_matmul(a, b, _gemm_route(a, b))


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
    return launch_matmul_bn_stats(a, b, out_dtype, _gemm_route(a, b))


matmul.launches = 0
matmul_bn_stats.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
matmul_bn_stats.launches_by_route = dict.fromkeys(ROUTES, 0)
