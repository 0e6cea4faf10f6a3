"""Train-mode batch norm after its statistics: the normalise and the
two-reduction backward of x (..., C).

The hand-written CUDA kernels of ``csrc/bn_train.cu`` replace no TPU kernel:
XLA fuses the JAX package's ``_bn_core_fwd_impl`` and ``_bn_core_bwd``
(``dorknet_tpu/ops/norm.py``) into a few passes, and these kernels do the same
work in 7 activation passes, where eager PyTorch ops took 22:

- ``bn_apply(x, mean, var, gamma, beta, eps)`` -> ``(y, norm)``: y = gamma *
  ((x - mean) * inv) + beta in x's dtype, with inv = rsqrt(var + eps), and
  ``norm`` (2, C) fp32, a copy of mean and inv, which the backward reads;
- ``bn_bwd_reduce(gy, x, norm, gamma)`` -> ``(dgamma, dbeta, coef)``: the
  sums of gy and gy * x^ over the rows, x^ recomputed from x with the
  forward's arithmetic and rounded to x's dtype, and ``coef`` (3, C), the
  factors gamma * inv, dbeta / M and dgamma / M;
- ``bn_bwd_dx(gy, x, norm, coef)`` -> dx = gamma * inv * (gy - dbeta / M -
  x^ * dgamma / M) in gy's dtype.

Each computes in fp32, every operation rounded on its own, in the JAX
formula's order. On a CUDA tensor each launches its kernel, or raises; on a
CPU tensor it computes the same function with its plain PyTorch version
(``*_plain``). Launches are counted in each one's ``.launches``, and
``bn_apply``'s also by activation in ``.launches_by_act``.

Each takes ``act``, the activation that follows the batch norm: ``"none"``,
``"relu"`` or ``"hswish"`` (``ops/activation.BN_ACTIVATIONS``). With one,
``bn_apply`` returns act(y) and writes no y; ``bn_bwd_reduce`` and
``bn_bwd_dx`` take ``gy``, the gradient of act(y), and gamma and beta
besides: they recompute y from x with the forward's arithmetic, rounded to
x's dtype, and differentiate the activation there as the unfused autograd
chain does (ReLU's 0 at y == 0, hard-swish's clip 0.5 at y + 3 == 0 and
6). The forward is bit-equal to the unfused chain; so is the activation's
gradient in fp32. In bf16 the activation's gradient stays in fp32 where
the unfused chain rounds it to bf16 before the batch norm's backward.
"""

import torch

from dorknet_tpu_torch.ops.activation import BN_ACTIVATIONS, clip, constant
from dorknet_tpu_torch.ops.cuda.bn_stats import sm_count
from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library

# the pointwise passes aim at this many threads a SM (its most resident)
_THREADS_PER_SM = 2048
# the reduction: blocks of REDUCE_THREADS threads (a wide tile up to
# MAX_TILE), bands of at least MIN_LANE_ROWS rows a lane, about one full
# wave of blocks
REDUCE_THREADS, MAX_TILE, MIN_LANE_ROWS = 256, 512, 16
_MAX_BANDS = 65535
# the C entry points' act codes
ACT_CODE = {"none": 0, "relu": 1, "hswish": 2}


def _rows(x):
    C = x.shape[-1]
    return x.numel() // C, C


def _check_act(what, name, x, like=None):
    if x.dim() < 1 or x.shape[-1] == 0 or x.numel() == 0:
        raise ValueError("{}: {} must be (..., C) with rows and channels, got shape {}".format(
            what, name, tuple(x.shape)))
    if x.dtype not in DTYPE_CODE:
        raise TypeError("{}: {} must be float32 or bfloat16, got {}".format(what, name, x.dtype))
    if not x.is_contiguous():
        raise ValueError("{}: {} must be contiguous".format(what, name))
    if like is not None and (x.shape != like.shape or x.dtype != like.dtype
                             or x.device != like.device):
        raise ValueError("{}: {} must match x's shape, dtype and device".format(what, name))


def _check_chan(what, x, **vectors):
    """Each named vector is fp32 on x's device, contiguous, of shape (C,) or,
    for ``norm`` and ``coef``, (2, C) and (3, C)."""
    C = x.shape[-1]
    rows = {"norm": 2, "coef": 3}
    for name, v in vectors.items():
        shape = (rows[name], C) if name in rows else (C,)
        if tuple(v.shape) != shape or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError("{}: {} must be contiguous float32 of shape {}, got {} {}".format(
                what, name, shape, v.dtype, tuple(v.shape)))
        if v.device != x.device:
            raise ValueError("{}: {} is on {}, x on {}".format(what, name, v.device, x.device))


def vector_width(C, dtype, *tensors):
    """The channels a thread reads at once: a 16-byte vector (4 fp32, 8
    bf16) where C is a multiple of it and every tensor is 16-byte aligned,
    else 1 (the scalar route)."""
    V = 16 // dtype.itemsize
    if C % V == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return V
    return 1


def pointwise_threads(M, C, V, sms):
    """The grid of the normalise and dx passes: a whole number of rows of the
    C / V channel vectors (so each thread keeps one channel vector), about
    _THREADS_PER_SM a SM, at most M rows."""
    cv = C // V
    return max(1, min(M, _THREADS_PER_SM * sms // cv)) * cv


def reduce_tiling(M, C, V, sms):
    """(tile, lanes, bands) of the reduction's first pass: a block holds
    ``tile`` channel vectors (balanced tiles of at most MAX_TILE) and
    REDUCE_THREADS // tile row lanes; about one full wave of blocks, lanes of
    at least MIN_LANE_ROWS rows, at most 65535 bands and never more bands
    than rows."""
    cv = C // V
    tiles = -(-cv // MAX_TILE)
    tile = -(-cv // tiles)
    lanes = max(1, REDUCE_THREADS // tile)
    blocks_per_sm = max(1, _THREADS_PER_SM // (tile * lanes))
    want = min(-(-blocks_per_sm * sms // tiles), -(-M // (lanes * MIN_LANE_ROWS)))
    return tile, lanes, max(1, min(want, _MAX_BANDS, M))


def _ptr(t):
    """A tensor's address, or NULL for an argument the kernel does not read."""
    return None if t is None else t.data_ptr()


def _launch_args(x):
    return DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream, x.device.index


def _on_card(what, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(what, x.device))
    return True


def _check_act_name(what, act):
    if act not in ACT_CODE:
        raise ValueError("{}: act must be one of {}, got {!r}".format(what, sorted(ACT_CODE), act))


def _xhat_saved(x, norm):
    """x^ as the backward reads it: (x - mean) * inv in fp32, rounded to x's
    dtype (what the JAX forward saves), widened back."""
    return ((x.float() - norm[0]) * norm[1]).to(x.dtype).float()


def _affine(x, mean, inv, gamma, beta):
    """y = gamma * ((x - mean) * inv) + beta in fp32, rounded to x's dtype."""
    return (gamma * ((x.float() - mean) * inv) + beta).to(x.dtype)


def _dy(gy, x, norm, gamma, beta, act):
    """The batch norm's dy in fp32 from gy, the gradient of act(y): y
    recomputed from x, rounded to x's dtype, and the unfused autograd
    chain's rules in its order, every step in fp32."""
    g = gy.float()
    if act == "none":
        return g
    y = _affine(x, norm[0], norm[1], gamma, beta)
    yf = y.float()
    if act == "relu":  # threshold_backward: 0 where y <= 0
        return torch.where(yf <= 0, torch.zeros_like(g), g)
    sixth = constant(1.0 / 6.0, y.dtype).float()
    t = (yf + 3.0).to(y.dtype).float()
    h = (clip(t, 0.0, 6.0) * sixth).to(y.dtype).float()
    through = (g * yf) * sixth
    through = torch.where((t == 0) | (t == 6), through * 0.5, through)
    through = torch.where((t < 0) | (t > 6), torch.zeros_like(g), through)
    return g * h + through


def bn_apply_plain(x, mean, var, gamma, beta, eps, act="none"):
    inv = torch.rsqrt(var + eps)
    return BN_ACTIVATIONS[act](_affine(x, mean, inv, gamma, beta)), torch.stack([mean, inv])


def bn_bwd_reduce_plain(gy, x, norm, gamma, beta=None, act="none"):
    M, C = _rows(x)
    x = x.reshape(M, C)
    gyf = _dy(gy.reshape(M, C), x, norm, gamma, beta, act)
    x_hat = _xhat_saved(x, norm)
    dbeta = gyf.sum(dim=0)
    dgamma = (gyf * x_hat).sum(dim=0)
    count = torch.full_like(dbeta, float(M))  # a true division, as the kernel's
    return dgamma, dbeta, torch.stack([gamma * norm[1], dbeta / count, dgamma / count])


def bn_bwd_dx_plain(gy, x, norm, coef, gamma=None, beta=None, act="none"):
    scale, mb, mg = coef
    gyf = _dy(gy, x, norm, gamma, beta, act)
    return (scale * (gyf - mb - _xhat_saved(x, norm) * mg)).to(gy.dtype)


def bn_apply(x, mean, var, gamma, beta, eps, act="none"):
    """x: (..., C) contiguous float32 or bfloat16; mean, var (the batch
    statistics), gamma and beta: float32 (C,). Returns (y, norm): y =
    act(gamma * x^ + beta) in x's dtype, norm float32 (2, C), mean and inv =
    rsqrt(var + eps)."""
    _check_act_name("bn_apply", act)
    _check_act("bn_apply", "x", x)
    _check_chan("bn_apply", x, mean=mean, var=var, gamma=gamma, beta=beta)
    if not _on_card("bn_apply", x):
        return bn_apply_plain(x, mean, var, gamma, beta, eps, act)
    M, C = _rows(x)
    y = torch.empty_like(x)
    norm = torch.empty((2, C), dtype=torch.float32, device=x.device)
    V = vector_width(C, x.dtype, x, y)
    G = pointwise_threads(M, C, V, sm_count(x.device.index))
    kernels = load_library()
    err = kernels.lib.dorknet_bn_apply(
        x.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        float(eps), y.data_ptr(), norm.data_ptr(), M, C, int(V > 1), ACT_CODE[act], G,
        *_launch_args(x))
    check(kernels.lib, err, "bn_apply launch")
    bn_apply.launches += 1
    bn_apply.launches_by_act[act] += 1
    return y, norm


def _check_backward(what, x, act, vectors, affine):
    """The backward's per-channel inputs: ``vectors``, and with an
    activation, which recomputes y from them, ``affine`` (gamma, beta)."""
    _check_act_name(what, act)
    if act != "none":
        gamma, beta = affine
        if gamma is None or beta is None:
            raise ValueError("{}: act={!r} needs gamma and beta".format(what, act))
        vectors = dict(vectors, gamma=gamma, beta=beta)
    _check_chan(what, x, **vectors)


def bn_bwd_reduce(gy, x, norm, gamma, beta=None, act="none"):
    """gy and x: (..., C) contiguous, one dtype (float32 or bfloat16); norm:
    bn_apply's (2, C); gamma float32 (C,), and with an activation beta too;
    gy the gradient of bn_apply's output under the same act. Returns
    (dgamma, dbeta, coef): float32 (C,), (C,) and (3, C). Deterministic: the
    same input gives bit-equal results."""
    _check_act("bn_bwd_reduce", "x", x)
    _check_act("bn_bwd_reduce", "gy", gy, like=x)
    _check_backward("bn_bwd_reduce", x, act, dict(norm=norm, gamma=gamma), (gamma, beta))
    if not _on_card("bn_bwd_reduce", x):
        return bn_bwd_reduce_plain(gy, x, norm, gamma, beta, act)
    M, C = _rows(x)
    V = vector_width(C, x.dtype, gy, x)
    tile, lanes, P = reduce_tiling(M, C, V, sm_count(x.device.index))
    partials = torch.empty((P, 2, C), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, C), dtype=torch.float32, device=x.device)
    coef = torch.empty((3, C), dtype=torch.float32, device=x.device)
    kernels = load_library()
    err = kernels.lib.dorknet_bn_bwd_reduce(
        gy.data_ptr(), x.data_ptr(), norm.data_ptr(), gamma.data_ptr(), _ptr(beta),
        partials.data_ptr(), grads.data_ptr(), coef.data_ptr(), M, C, tile, lanes, P,
        int(V > 1), ACT_CODE[act], *_launch_args(x))
    check(kernels.lib, err, "bn_bwd_reduce launch")
    bn_bwd_reduce.launches += 1
    return grads[0], grads[1], coef


def bn_bwd_dx(gy, x, norm, coef, gamma=None, beta=None, act="none"):
    """gy and x: (..., C) contiguous, one dtype; norm (2, C) and coef (3, C)
    from bn_apply and bn_bwd_reduce; with an activation, gamma and beta
    float32 (C,). Returns dx in gy's dtype and shape."""
    _check_act("bn_bwd_dx", "x", x)
    _check_act("bn_bwd_dx", "gy", gy, like=x)
    _check_backward("bn_bwd_dx", x, act, dict(norm=norm, coef=coef), (gamma, beta))
    if not _on_card("bn_bwd_dx", x):
        return bn_bwd_dx_plain(gy, x, norm, coef, gamma, beta, act)
    M, C = _rows(x)
    dx = torch.empty_like(gy)
    V = vector_width(C, x.dtype, gy, x, dx)
    G = pointwise_threads(M, C, V, sm_count(x.device.index))
    kernels = load_library()
    err = kernels.lib.dorknet_bn_bwd_dx(
        gy.data_ptr(), x.data_ptr(), norm.data_ptr(), coef.data_ptr(), _ptr(gamma), _ptr(beta),
        dx.data_ptr(), M, C, int(V > 1), ACT_CODE[act], G, *_launch_args(x))
    check(kernels.lib, err, "bn_bwd_dx launch")
    bn_bwd_dx.launches += 1
    return dx


bn_apply.launches = 0
bn_apply.launches_by_act = dict.fromkeys(ACT_CODE, 0)
bn_bwd_reduce.launches = 0
bn_bwd_dx.launches = 0
