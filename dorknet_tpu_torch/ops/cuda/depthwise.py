"""Depthwise 3x3 convolution (padding 1, stride 1 or 2) over NHWC tensors,
forward and backward.

Three hand-written CUDA kernels replace the Pallas kernel
``dorknet_tpu/ops/pallas/depthwise.py:depthwise3x3`` and its custom VJP
``_depthwise_bwd``:

- ``depthwise3x3`` (``csrc/depthwise3x3.cu``): the forward;
- ``depthwise3x3_dx`` (``csrc/depthwise3x3_bwd.cu``): the gradient of x, the
  forward's transpose read directly;
- ``depthwise3x3_dw`` (the same file): the gradient of w, a nine-tap
  reduction in two passes, deterministic.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU tensor
it computes the same function with its plain PyTorch version (``*_plain``).
Nothing sends a CUDA tensor to a plain version. ``Depthwise3x3Fn`` joins the
three for autograd, and ``depthwise3x3`` goes through it whenever a gradient
is needed. Each wrapper counts the launches of its kernel in ``.launches``.

Each kernel has two routes, chosen by shape and alignment before the
launch, and each wrapper counts its launches per route in
``.launches_by_route``:

- the forward (``_dw_route``) and dx (``_dx_route``): ``"vector"``, 16-byte
  vectors of channels (4 fp32 or 8 bf16) in strips of ``dw_strip`` outputs,
  when C is a multiple of that and the activation read is 16-byte aligned;
  ``"scalar"``, one thread per element, otherwise. The two routes give
  bit-equal results.
- dw (``_dwgrad_route``): ``"vector"``, 4 channels a thread (16 bytes fp32,
  8 bytes bf16) walking strips of outputs over ``dw_vec_bands`` bands, when
  C is a multiple of 4 and x and g are aligned to 4 channels; ``"scalar"``
  over ``dw_bands`` bands otherwise. They sum in different orders; each is
  bit-equal to itself on repeat, and both are held to the plain version.

``launch_forward``, ``launch_dx`` and ``launch_dw`` run a given route, for
A/Bs on the same inputs.
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.ops.cuda.build import DTYPE_CODE, check, load_library


# dw pass 1 aims at this many blocks per SM (see csrc/depthwise3x3_bwd.cu):
# the scalar route's blocks of 256 threads, the vector route's of 128 (one
# wave at about 120 registers a thread; fewer or more were slower in an A/B
# on an H100)
_DW_BLOCKS_PER_SM = 8
_DW_VEC_BLOCKS_PER_SM = 4
_DW_VEC_TW = 8  # outputs wo of a dw vector strip (DWV_TW in the kernel)
_DW_VEC_ROWS = {torch.float32: 1, torch.bfloat16: 2}  # its output rows (DwVec::TH)
_DW_VEC_CHANNELS = 4  # channels of a dw vector thread (DwVec::V)
_VEC_THREADS, _VEC_TILE = 128, 32  # a vector block's threads, its channel vectors at most
ROUTES = ("scalar", "vector")  # their codes at the C entry points: 0, 1
_VEC_BYTES = 16
# the vector route's strip widths, widest first, and the threads per SM a
# layer should still give the card. Wide strips win while each SM keeps a
# few warps, even at the 7x7x512 layer whose strip of 8 leaves about 220
# threads an SM in bf16 (chip_smoke.py phase 5 times every width)
_STRIPS = (8, 4, 2, 1)
_THREADS_PER_SM = 128


def _out_hw(H, W, stride):
    return (H - 1) // stride + 1, (W - 1) // stride + 1


def sum_dtype(t):
    """The plain versions sum in fp32, or in fp64 for fp64 inputs (the
    finite-difference checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_stride(stride):
    if stride not in (1, 2):
        raise ValueError("depthwise3x3: stride must be 1 or 2, got {}".format(stride))


def _check_act(t, what):
    if t.dim() != 4:
        raise ValueError("depthwise3x3: {} must be (N,H,W,C), got shape {}".format(
            what, tuple(t.shape)))
    if t.dtype not in DTYPE_CODE:
        raise TypeError("depthwise3x3: {} must be float32 or bfloat16, got {}".format(
            what, t.dtype))
    if not t.is_contiguous():
        raise ValueError("depthwise3x3: {} must be contiguous NHWC".format(what))


def _check_w(w, t, what):
    """w must be the contiguous float32 (C,3,3) filter of activation t."""
    C = t.shape[3]
    if tuple(w.shape) != (C, 3, 3) or w.dtype != torch.float32:
        raise ValueError("depthwise3x3: w must be float32 ({}, 3, 3), got {} {}".format(
            C, w.dtype, tuple(w.shape)))
    if not w.is_contiguous():
        raise ValueError("depthwise3x3: w must be contiguous")
    if w.device != t.device:
        raise ValueError("depthwise3x3: {} on {} but w on {}".format(
            what, t.device, w.device))


def _validate(x, w, stride):
    _check_stride(stride)
    _check_act(x, "x")
    _check_w(w, x, "x")


def _validate_grad(g, x_shape, dtype, device, stride):
    """g (already checked by _check_act) must be the (N,Ho,Wo,C) gradient of
    the forward's output."""
    N, H, W, C = x_shape
    want = (N, *_out_hw(H, W, stride), C)
    if tuple(g.shape) != want or g.dtype != dtype or g.device != device:
        raise ValueError("depthwise3x3: g must be {} {} on {}, got {} {} on {}".format(
            dtype, want, device, g.dtype, tuple(g.shape), g.device))


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError("depthwise3x3: unsupported device {}".format(t.device))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------- #
# Plain PyTorch versions (the CPU path, and what the kernels are held to)
# ---------------------------------------------------------------------- #
def depthwise3x3_plain(x, w, stride):
    """The forward in plain PyTorch: pad 1, then nine shifted and strided
    slices times the weights, summed in fp32, cast back to x's dtype.
    x: (N,H,W,C); w: (C,3,3) fp32."""
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, stride)
    acc_dtype = sum_dtype(x)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((N, Ho, Wo, C), dtype=acc_dtype, device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + stride * (Ho - 1) + 1:stride,
                     dj:dj + stride * (Wo - 1) + 1:stride, :]
            acc = acc + tap * w[:, di, dj]
    return acc.to(x.dtype)


def depthwise3x3_dx_plain(g, w, stride, H, W):
    """dx in plain PyTorch, as the forward's transpose: each tap's product
    g * w[:, di, dj] is added back onto the padded x grid at the strided
    positions that tap read, and the padding is cropped. g: (N,Ho,Wo,C);
    returns (N,H,W,C) in g's dtype."""
    N, Ho, Wo, C = g.shape
    acc_dtype = sum_dtype(g)
    gf = g.to(acc_dtype)
    acc = torch.zeros((N, H + 2, W + 2, C), dtype=acc_dtype, device=g.device)
    for di in range(3):
        for dj in range(3):
            acc[:, di:di + stride * (Ho - 1) + 1:stride,
                dj:dj + stride * (Wo - 1) + 1:stride, :] += gf * w[:, di, dj]
    return acc[:, 1:H + 1, 1:W + 1, :].to(g.dtype).contiguous()


def depthwise3x3_dw_plain(x, g, stride):
    """dw in plain PyTorch: for each of the nine taps, the strided slice of
    the padded x times g, summed over (N, Ho, Wo). Returns (C,3,3) in fp32
    (fp64 for fp64 inputs)."""
    N, Ho, Wo, C = g.shape
    acc_dtype = sum_dtype(x)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    gf = g.to(acc_dtype)
    taps = [(xp[:, di:di + stride * (Ho - 1) + 1:stride,
                dj:dj + stride * (Wo - 1) + 1:stride, :] * gf).sum(dim=(0, 1, 2))
            for di in range(3) for dj in range(3)]
    return torch.stack(taps, dim=1).reshape(C, 3, 3)


# ---------------------------------------------------------------------- #
# Kernel wrappers
# ---------------------------------------------------------------------- #
def _vec_channels(dtype):
    """Channels in one 16-byte vector: 4 fp32 or 8 bf16."""
    return _VEC_BYTES // torch.empty((), dtype=dtype).element_size()


def _dw_route(x):
    """The forward's route for x (N,H,W,C), and dx's for g (``_dx_route``):
    ``"vector"`` when C is a multiple of a 16-byte vector of channels and
    the activation read is 16-byte aligned (the wrapper allocates the output
    aligned), else ``"scalar"``."""
    if x.shape[3] % _vec_channels(x.dtype) == 0 and x.data_ptr() % _VEC_BYTES == 0:
        return "vector"
    return "scalar"


# dx reads g and writes dx as the forward reads x and writes y
_dx_route = _dw_route


def _dwgrad_route(x, g):
    """dw's route for x (N,H,W,C) and g (N,Ho,Wo,C): ``"vector"`` when C is
    a multiple of 4 and both are aligned to 4 channels (16 bytes fp32, 8
    bytes bf16), else ``"scalar"``. ``g`` may be an offset view (autograd's
    ``contiguous()``), so both pointers are checked."""
    nbytes = _DW_VEC_CHANNELS * x.element_size()
    if (x.shape[3] % _DW_VEC_CHANNELS == 0 and x.data_ptr() % nbytes == 0
            and g.data_ptr() % nbytes == 0):
        return "vector"
    return "scalar"


def _check_route(route):
    if route not in ROUTES:
        raise ValueError("depthwise3x3: route must be one of {}, got {!r}".format(ROUTES, route))


def dw_strip(N, Ho, Wo, vectors, sms):
    """The vector route's strip, for the forward (output N, Ho, Wo) and for
    dx (output N, H, W): the widest of 8, 4, 2 outputs along W that still
    gives at least ``_THREADS_PER_SM`` threads (one per output strip and
    channel vector) per SM, else 1. Each thread keeps the taps of its strip
    in registers, so wider strips read each input once; the floor keeps
    small layers (small batches) spread over the SMs."""
    for tw in _STRIPS[:-1]:
        if N * Ho * -(-Wo // tw) * vectors >= _THREADS_PER_SM * sms:
            return tw
    return _STRIPS[-1]


def _sms(t):
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def launch_forward(x, w, stride, route, tw=None):
    """The forward kernel of ``route`` on CUDA tensors (x and w already
    checked); ``tw`` overrides the vector route's strip. ``depthwise3x3``
    takes ``_dw_route(x)``; this launcher also serves to hold one route
    against the other on the same inputs. The C side refuses a route or a
    strip the input cannot take."""
    _check_route(route)
    _require_cuda(x)
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, stride)
    y = torch.empty((N, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if tw is None:
        tw = 1
        if route == "vector":
            tw = dw_strip(N, Ho, Wo, C // _vec_channels(x.dtype), _sms(x))
    kernels = load_library()
    err = kernels.lib.dorknet_depthwise3x3_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, stride,
        DTYPE_CODE[x.dtype], ROUTES.index(route), tw, _stream(x), x.device.index)
    check(kernels.lib, err, "depthwise3x3 launch ({} route)".format(route))
    depthwise3x3.launches += 1
    depthwise3x3.launches_by_route[route] += 1
    return y


def _forward(x, w, stride):
    """The forward on x's device: the plain version for a CPU tensor, the
    kernel of its route for a CUDA one."""
    if x.device.type == "cpu":
        return depthwise3x3_plain(x, w, stride)
    return launch_forward(x, w, stride, _dw_route(x))


def launch_dx(g, w, stride, H, W, route, tw=None):
    """The dx kernel of ``route`` on CUDA tensors (g and w already checked);
    ``tw`` overrides the vector route's strip (``dw_strip`` over dx's N, H,
    W by default). ``depthwise3x3_dx`` takes ``_dx_route(g)``. The C side
    refuses a route or a strip the input cannot take."""
    _check_route(route)
    _require_cuda(g)
    N, _, _, C = g.shape
    dx = torch.empty((N, H, W, C), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    if tw is None:
        tw = 1
        if route == "vector":
            tw = dw_strip(N, H, W, C // _vec_channels(g.dtype), _sms(g))
    kernels = load_library()
    err = kernels.lib.dorknet_depthwise3x3_dx(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), N, H, W, C, stride,
        DTYPE_CODE[g.dtype], ROUTES.index(route), tw, _stream(g), g.device.index)
    check(kernels.lib, err, "depthwise3x3_dx launch ({} route)".format(route))
    depthwise3x3_dx.launches += 1
    depthwise3x3_dx.launches_by_route[route] += 1
    return dx


def depthwise3x3_dx(g, w, stride, H, W):
    """Gradient of x. g: (N,Ho,Wo,C) contiguous, float32 or bfloat16;
    w: (C,3,3) float32; (H, W) the forward input's size. Returns (N,H,W,C)
    in g's dtype, accumulated in fp32."""
    _check_stride(stride)
    _check_act(g, "g")
    _check_w(w, g, "g")
    N, _, _, C = g.shape
    _validate_grad(g, (N, H, W, C), g.dtype, g.device, stride)
    if g.device.type == "cpu":
        return depthwise3x3_dx_plain(g, w, stride, H, W)
    return launch_dx(g, w, stride, H, W, _dx_route(g))


def dw_bands(N, Ho, Wo, C, sms):
    """How many bands of the N*Ho*Wo output pixels dw's scalar route splits
    the reduction into: about ``_DW_BLOCKS_PER_SM`` blocks per SM over the
    channel tiles, at least 64 pixels a band, at most 65535 bands."""
    tiles = -(-C // 32)
    want = -(-_DW_BLOCKS_PER_SM * sms // tiles)
    return max(1, min(want, -(-N * Ho * Wo // 64), 65535))


def dw_vec_bands(N, Ho, Wo, C, sms, rows=1):
    """How many bands dw's vector route splits its strips into, a strip
    being ``rows`` output rows (``_DW_VEC_ROWS`` of the dtype) by
    ``_DW_VEC_TW`` outputs: about ``_DW_VEC_BLOCKS_PER_SM`` blocks per SM
    over the channel tiles (a block holds at most 32 threads of 4 channels
    each, and 128 threads), at least one strip for each of a block's lanes,
    at most 65535 bands. Fewer bands also mean fewer partials for pass 2."""
    vectors = C // _DW_VEC_CHANNELS
    tile = min(vectors, _VEC_TILE)
    lanes = _VEC_THREADS // tile
    tiles = -(-vectors // tile)
    strips = N * -(-Ho // rows) * -(-Wo // _DW_VEC_TW)
    want = -(-_DW_VEC_BLOCKS_PER_SM * sms // tiles)
    return max(1, min(want, strips // lanes, 65535))


def launch_dw(x, g, stride, route):
    """The dw kernels of ``route`` on CUDA tensors (x and g already
    checked), over the route's bands (``dw_vec_bands`` or ``dw_bands``).
    ``depthwise3x3_dw`` takes ``_dwgrad_route(x, g)``; this launcher also
    serves to hold one route against the other on the same inputs. The C
    side refuses a route the input cannot take."""
    _check_route(route)
    _require_cuda(x)
    N, H, W, C = x.shape
    Ho, Wo = _out_hw(H, W, stride)
    if g.numel() == 0:
        return torch.zeros((C, 3, 3), dtype=torch.float32, device=x.device)
    if route == "vector":
        bands = dw_vec_bands(N, Ho, Wo, C, _sms(x), _DW_VEC_ROWS[x.dtype])
    else:
        bands = dw_bands(N, Ho, Wo, C, _sms(x))
    partials = torch.empty((bands, 9, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((C, 3, 3), dtype=torch.float32, device=x.device)
    kernels = load_library()
    err = kernels.lib.dorknet_depthwise3x3_dw(
        x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(),
        N, H, W, C, stride, bands, DTYPE_CODE[x.dtype], ROUTES.index(route), _stream(x),
        x.device.index)
    check(kernels.lib, err, "depthwise3x3_dw launch ({} route)".format(route))
    depthwise3x3_dw.launches += 1
    depthwise3x3_dw.launches_by_route[route] += 1
    return dw


def depthwise3x3_dw(x, g, stride):
    """Gradient of w. x: (N,H,W,C) and g: (N,Ho,Wo,C), contiguous, both
    float32 or both bfloat16. Returns (C,3,3) float32. Deterministic: the
    same inputs give bit-equal results."""
    _check_stride(stride)
    _check_act(x, "x")
    _check_act(g, "g")
    _validate_grad(g, tuple(x.shape), x.dtype, x.device, stride)
    if x.device.type == "cpu":
        return depthwise3x3_dw_plain(x, g, stride)
    return launch_dw(x, g, stride, _dwgrad_route(x, g))


class Depthwise3x3Fn(torch.autograd.Function):
    """Depthwise 3x3 with the hand-written backward: the counterpart of the
    JAX package's ``jax.custom_vjp`` on ``depthwise3x3``. On CUDA tensors
    the forward, dx and dw kernels launch; on CPU tensors their plain
    versions run (in fp64 too, for finite-difference checks)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return _forward(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        g = g.contiguous()
        dx = dw = None
        if x.device.type == "cpu":
            if ctx.needs_input_grad[0]:
                dx = depthwise3x3_dx_plain(g, w, s, x.shape[1], x.shape[2])
            if ctx.needs_input_grad[1]:
                dw = depthwise3x3_dw_plain(x, g, s).to(w.dtype)
            return dx, dw, None
        if ctx.needs_input_grad[0]:
            dx = depthwise3x3_dx(g, w, s, x.shape[1], x.shape[2])
        if ctx.needs_input_grad[1]:
            dw = depthwise3x3_dw(x, g, s)
        return dx, dw, None


@torch.library.custom_op("dorknet::depthwise3x3", mutates_args=())
def depthwise3x3_op(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The forward as the registered op ``dorknet::depthwise3x3``, which
    ``torch.export`` records in a graph (a ctypes launch on ``data_ptr()``
    cannot be traced): the plain version on a CPU tensor, the kernel of its
    route on a CUDA one. The route, the strip and the SM count are read here,
    at run time, so a program exported with a symbolic batch still takes the
    vector route."""
    return _forward(x, w, stride)


@depthwise3x3_op.register_fake
def _depthwise3x3_fake(x, w, stride):
    N, H, W, C = x.shape
    return x.new_empty((N, *_out_hw(H, W, stride), C))


def depthwise3x3(x, w, stride=1):
    """Depthwise 3x3, padding 1, stride 1 or 2. x: (N,H,W,C) contiguous,
    float32 or bfloat16; w: (C,3,3) float32. Returns (N,Ho,Wo,C) in x's
    dtype, accumulated in fp32. Bias is the caller's. Differentiable: with a
    gradient needed it runs through ``Depthwise3x3Fn``; without one, through
    the registered op ``depthwise3x3_op``."""
    _validate(x, w, stride)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Depthwise3x3Fn.apply(x, w, stride)
    return depthwise3x3_op(x, w, stride)


depthwise3x3.launches = 0
depthwise3x3.launches_by_route = dict.fromkeys(ROUTES, 0)
depthwise3x3_dx.launches = 0
depthwise3x3_dx.launches_by_route = dict.fromkeys(ROUTES, 0)
depthwise3x3_dw.launches = 0
depthwise3x3_dw.launches_by_route = dict.fromkeys(ROUTES, 0)
