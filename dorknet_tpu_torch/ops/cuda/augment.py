"""The fused training augmentation of uint8 batches: crop, HSV, three-shear
rotation and horizontal flip in one pass.

A hand-written CUDA kernel (``csrc/augment_planes.cu``) replaces the Pallas
kernel ``dorknet_tpu/ops/pallas/augment.py:augment_planes_fused``. It reads
the (B, H, W, 3) uint8 HWC batch that the loader and the resident dataset
hold, and writes the (B, 3, oh, ow) uint8 planes that the JAX function
returns, so the two compare directly.

``augment_param_table`` turns the draws of ``draw_batch_params`` into one
(B, 8) fp32 row per image, shared by the kernel and the plain version:

    [crop row, crop col, H scale, S scale, V scale, a, b, flip]

with the crop origin of every mode (random, center, none), a = -tan(theta/2)
and b = sin(theta) of the rotation angle (``shear_coefs``; the kernel
computes no trigonometry of its own), and flip 1.0 or 0.0.

On a CUDA tensor ``augment_planes_fused`` launches the kernel or raises; on
a CPU tensor it runs ``augment_planes_fused_plain``, the planes algorithm of
``ops/augment.py`` with ``torch.roll`` and ``where``.
Nothing sends a CUDA tensor to the plain version. Each launch adds one to
``augment_planes_fused.launches``.

With rotation a block of the kernel owns a tile of about ``BAND_ROWS`` x
``BAND_COLS`` output pixels (``band_tile``) of one image, three channels,
and stages the windows of rows and columns that the shears read back from
it (``band_windows``, bounded by ``band_plan``). Its shared memory grows
with the tile and the rotation's reach, not with the plane, and a tile whose
windows exceed the plan (a table with angles beyond the range its margin was
sized for) computes each output byte from the input directly: every size
runs. Without rotation a pointwise kernel runs.
"""

import ctypes

import numpy as np
import torch

from dorknet_tpu_torch.ops.augment import (
    crop_batch_planes, flip_batch_planes, hsv_batch_planes, shear_coefs, shear_pad,
    shear_rotate_planes, to_uint8)
from dorknet_tpu_torch.ops.cuda.build import check, load_library

CROP_MODES = ("random", "center", None)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _geometry(x, out_hw, rotation_tuple, crop_mode):
    """(oh, ow, P): the output size (the input's with crop_mode None) and the
    rotation's zero margin (0 without rotation)."""
    if crop_mode not in CROP_MODES:
        raise ValueError("crop_mode must be one of {}, got {!r}".format(CROP_MODES, crop_mode))
    H, W = x.shape[1], x.shape[2]
    oh, ow = (H, W) if crop_mode is None else (int(out_hw[0]), int(out_hw[1]))
    if oh < 1 or ow < 1 or oh > H or ow > W:
        raise ValueError("augment_planes_fused: output {}x{} does not fit the {}x{} "
                         "input".format(oh, ow, H, W))
    P = shear_pad(rotation_tuple, oh, ow) if rotation_tuple is not None else 0
    return oh, ow, P


def augment_param_table(params, batch, precrop_hw, out_hw, hsv_pert_tuples=None,
                        rotation_tuple=None, horizontal_flip_prob=None,
                        crop_mode="random", device="cpu"):
    """The (B, 8) fp32 table of one call: rows of [r, c, sh, ss, sv, a, b,
    flip] from ``params`` (``draw_batch_params``). Unused columns hold
    neutral values (origin 0, scales 1, a = b = 0, no flip)."""
    table = torch.zeros((batch, 8), dtype=torch.float32, device=device)
    table[:, 2:5] = 1.0
    if crop_mode == "random":
        table[:, 0] = params["crop_r"].to(device, torch.float32)
        table[:, 1] = params["crop_c"].to(device, torch.float32)
    elif crop_mode == "center":
        table[:, 0] = (precrop_hw[0] - out_hw[0]) // 2
        table[:, 1] = (precrop_hw[1] - out_hw[1]) // 2
    if hsv_pert_tuples is not None:
        table[:, 2:5] = params["hsv_scales"].to(device, torch.float32)
    if rotation_tuple is not None:
        a, b = shear_coefs(params["deg"].to(device))
        table[:, 5] = a
        table[:, 6] = b
    if horizontal_flip_prob is not None:
        table[:, 7] = params["flip"].to(device, torch.float32)
    return table


def augment_planes_fused_plain(x, table, out_hw, hsv_on, P, flip_on):
    """The plain PyTorch version, from the same table: the planes algorithm
    (barrel-shift crop, HSV in fp32 rounded half up to uint8, three shears
    each rounded back to uint8, flip). x (B,H,W,3) uint8 -> (B,3,oh,ow)
    uint8. P = 0: no rotation."""
    planes = x.permute(0, 3, 1, 2)
    planes = crop_batch_planes(planes, table[:, 0].long(), table[:, 1].long(), out_hw)
    if hsv_on:
        planes = to_uint8(hsv_batch_planes(planes.float(), table[:, 2:5]) + 0.5)
    if P:
        planes = shear_rotate_planes(planes, table[:, 5], table[:, 6], P)
    if flip_on:
        planes = flip_batch_planes(planes, table[:, 7] != 0)
    return planes.contiguous()


def _validate(x):
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError("augment_planes_fused: x must be (B,H,W,3), got shape {}".format(
            tuple(x.shape)))
    if x.dtype != torch.uint8:
        raise TypeError("augment_planes_fused: x must be uint8 (the kernel rounds every "
                        "stage to uint8), got {}; float precrop batches on the card are "
                        "ROADMAP A5".format(x.dtype))
    if not x.is_contiguous():
        raise ValueError("augment_planes_fused: x must be contiguous")


BAND_ROWS = 45   # output rows of a tile, at most (band_tile)
BAND_COLS = 75   # output columns of a tile, at most
BAND_WARPS = 8   # warps of a block (csrc/augment_planes.cu kBandWarps)


def band_tile(oh, ow):
    """The band route's default tile for an oh x ow output: BAND_ROWS x
    BAND_COLS, each side shrunk to cut its length into equal parts (225 x
    225 takes 45 x 75), so that no band or column chunk is a sliver that
    stages a whole halo for a few outputs."""
    return tuple(-(-n // -(-n // t)) for n, t in ((oh, BAND_ROWS), (ow, BAND_COLS)))


def t_hi_of(P):
    """The largest shift of a line, 2^bitlen(2P - 2) - 1 (the plain
    version's barrel shift covers nbits bits)."""
    return (1 << int(2 * P - 2).bit_length()) - 1


def shift_bound(oh, ow, P):
    """The largest |a| and |b| (the shears' coefficients) of any angle in a
    range whose margin is P: shear_pad makes P - 2 at least max(tan(m/2),
    sin(m)) * max(oh, ow) / 2 for the range's largest angle m, which bounds
    |a| = tan(|theta|/2) and |b| = |sin(theta)|; a hair more for the fp32
    rounding of a and b."""
    return (P - 2) / (max(oh, ow) / 2.0) * (1 + 1e-6) + 1e-7


def _span(beta, lines, t_hi):
    """The most by which the integer shifts of `lines` consecutive lines can
    differ for a coefficient below beta: floor(beta * (lines - 1)) + 1, one
    more for the floors, never more than t_hi."""
    return min(t_hi, int(beta * (lines - 1)) + 2)


def band_plan(oh, ow, P, th=BAND_ROWS, tw=BAND_COLS):
    """The band route's capacities and shared memory for tiles of th x tw
    output pixels, as ``csrc/augment_planes.cu`` lays them out:
    (cap_j, cap_r, cap_k, smem). cap_j bounds the columns of the second
    shear's output that the third reads (tw and the spread of th rows'
    shifts), cap_r the padded rows that the second shear reads there (th and
    the spread of cap_j columns' shifts), cap_k the crop columns that the
    first shear reads on those rows (cap_j and the spread of cap_r rows'
    shifts); ``shift_bound`` bounds the spreads. A window longer than its
    period repeats indices (``band_windows``). smem: the column shifts (8
    bytes a column of J), the staged 3 x cap_r x cap_j bytes, and a region a
    warp (the crop row's bytes and its HSV, or three rows of the second
    shear)."""
    t_hi = t_hi_of(P)
    beta = shift_bound(oh, ow, P)
    cap_j = tw + _span(beta, th, t_hi) + 1
    cap_r = th + _span(beta, cap_j, t_hi) + 1
    cap_k = cap_j + _span(beta, cap_r, t_hi) + 1
    region = (4 * ((3 * ow + 6) // 4) + 3 * cap_k + 15) & ~15
    smem = ((8 * cap_j + 3 * cap_r * cap_j + 15) & ~15) + BAND_WARPS * region
    return cap_j, cap_r, cap_k, smem


def fit_band(oh, ow, P, limit, th=BAND_ROWS, tw=BAND_COLS):
    """(th, tw, cap_j, cap_r, cap_k): the tile, halved along its longer side
    until its plan fits ``limit`` bytes a block. Where not even one pixel's does, caps
    of 0 send every tile through the kernel's direct path, which stages
    nothing: every size runs."""
    while True:
        cap_j, cap_r, cap_k, smem = band_plan(oh, ow, P, th, tw)
        if smem <= limit:
            return th, tw, cap_j, cap_r, cap_k
        if th == tw == 1:
            return th, tw, 0, 0, 0
        th, tw = (max(1, th // 2), tw) if th >= tw else (th, max(1, tw // 2))


def _shift(coef, coord, P):
    """A line's integer shift, floor(clip(coef * coord + P, 0, t_hi)), each
    operation rounded in fp32 as the kernel and the plain version do."""
    t = np.float32(np.float32(coef) * np.float32(coord)) + np.float32(P)
    return int(np.floor(min(max(t, np.float32(0.0)), np.float32(t_hi_of(P)))))


def band_windows(a, b, oh, ow, P, rows, cols):
    """The band route's three windows for the output tile rows[0] <= y <
    rows[1], cols[0] <= x < cols[1] of an image with coefficients a, b, as
    ``csrc/augment_planes.cu:augment_band_kernel`` computes them: ((s, len)
    of J on the Wp columns, of R on the Hp padded rows, of K on the Wp
    padded columns), each the indices s .. s + len - 1 modulo its period. s
    is unwrapped, as the reads compute it: the kernel finds a read's slot as
    its unwrapped index minus s, with no modulo, and a window longer than its
    period repeats indices. Every shift is monotone along its lines, so the
    ends of a run bound it."""
    Wp, Hp = ow + 2 * P, oh + 2 * P
    cy, cx = np.float32(0.5 * oh), np.float32(0.5 * ow)

    def runs(w, period):  # the one or two runs of a window's indices, as (first, end)
        s, n = w[0] % period, w[1]
        if n >= period:
            return [(0, period)]
        return [(s, min(s + n, period))] + ([(0, s + n - period)] if s + n > period else [])

    y0, y1 = rows
    ty = [_shift(a, np.float32(y) - cy, P) for y in (y0, y1 - 1)]
    wj = (cols[0] + min(ty), (cols[1] - cols[0]) + abs(ty[1] - ty[0]) + 1)
    tc = [_shift(b, np.float32(j - P) - cx, P) for run in runs(wj, Wp) for j in
          (run[0], run[1] - 1)]
    wr = (y0 + min(tc), (y1 - y0) + max(tc) - min(tc) + 1)
    # the content rows of R (padded rows P .. P + oh - 1), in each of its runs
    content = [(max(s, P) - P, min(e, P + oh) - P) for s, e in runs(wr, Hp)]
    tr = [_shift(a, np.float32(c) - cy, P) for c0, c1 in content if c0 < c1
          for c in (c0, c1 - 1)] or [0]
    wk = (wj[0] + min(tr) - P, wj[1] + max(tr) - min(tr) + 1)
    return wj, wr, wk


def augment_planes_fused(x, params, out_hw, hsv_pert_tuples=None, rotation_tuple=None,
                         horizontal_flip_prob=None, crop_mode="random"):
    """Crop -> HSV -> rotate -> flip of a uint8 (B,H,W,3) BGR batch by
    ``params`` (``draw_batch_params``), as the JAX package's
    ``augment_batch_planes`` computes it for uint8 planes. Returns (B,3,oh,ow)
    uint8 ((B,3,H,W) with crop_mode None). On a CUDA tensor: one kernel
    launch, which runs every size, or an error (a float batch)."""
    _validate(x)
    oh, ow, P = _geometry(x, out_hw, rotation_tuple, crop_mode)
    B, H, W = x.shape[:3]
    table = augment_param_table(params, B, (H, W), (oh, ow), hsv_pert_tuples,
                                rotation_tuple, horizontal_flip_prob, crop_mode,
                                device=x.device)
    hsv_on = hsv_pert_tuples is not None
    flip_on = horizontal_flip_prob is not None
    if x.device.type == "cpu":
        return augment_planes_fused_plain(x, table, (oh, ow), hsv_on, P, flip_on)
    return launch_augment_kernel(x, table, (oh, ow), hsv_on, P)


def launch_augment_kernel(x, table, out_hw, hsv_on, P, tile=None):
    """The kernel alone, on a CUDA batch x (B,H,W,3) uint8 and the table of
    ``augment_param_table`` on the same device: returns (B,3,oh,ow) uint8.
    With rotation, in tiles of ``tile`` = (rows, columns), default
    ``band_tile``, halved by ``fit_band`` to what a block's shared memory
    holds. Counts the launch in ``augment_planes_fused.launches``."""
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("augment_planes_fused: the kernel needs x and the table on one "
                         "CUDA device, got {} and {}".format(x.device, table.device))
    B, H, W = x.shape[:3]
    oh, ow = out_hw
    out = torch.empty((B, 3, oh, ow), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    kernels = load_library()
    plan = (1, 1, 0, 0, 0)
    if P:
        limit = kernels.lib.dorknet_max_block_smem(x.device.index)
        if limit < 0:
            check(kernels.lib, -limit, "augment_planes_fused shared-memory query")
        plan = fit_band(oh, ow, P, limit, *(tile or band_tile(oh, ow)))
    err = kernels.lib.dorknet_augment_planes(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), B, H, W, oh, ow, P,
        ctypes.c_float(float(t_hi_of(P)) if P else 0.0), int(hsv_on), *plan, _stream(x),
        x.device.index)
    check(kernels.lib, err, "augment_planes_fused launch")
    augment_planes_fused.launches += 1
    return out


augment_planes_fused.launches = 0
