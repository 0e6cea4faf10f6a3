"""The plain stages of the planes augmentation over (B, C, H, W) tensors:
crop, cv2-matched HSV in fp32, the three-shear rotation with fp32 lerps and
round-half-up back to uint8 after every stage, and the flip (counterpart of
the planes half of ``dorknet_tpu/data_loading/device_augment.py``).

Each stage takes its draws as tensors. ``data_loading/device_augment.py``
chains them for float batches; ``ops/cuda/augment.py`` chains them as the
plain version its kernel is held to. The barrel shifts (rolls and selects)
stay here because they are an independent formulation of the reads that
the kernel makes at their addresses.
"""

import math

import numpy as np
import torch

# fp32 constants as the JAX package's compiled program uses them: XLA turns
# a division by a constant into a multiply by its fp32 reciprocal and folds
# deg * pi / 180 into deg * (pi * (1/180)). Each value is exact in fp32.
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_60 = float(np.float32(1.0) / np.float32(60.0))
_DEG_TO_RAD = float(np.float32(np.pi) * (np.float32(1.0) / np.float32(180.0)))


def _barrel_shift(x, t, dim, nbits):
    """Variable left shift along ``dim``: out[i] = x[(i + t) mod L], t an
    integer tensor >= 0 broadcastable to x with size 1 on ``dim``, below
    2**nbits: one roll and select per bit of t."""
    for j in range(nbits):
        rolled = torch.roll(x, -(1 << j), dims=dim)
        x = torch.where(((t >> j) & 1).bool(), rolled, x)
    return x


def to_uint8(v):
    """Clamp to [0, 255] and truncate: with the +0.5 the caller adds, cv2's
    round-half-up. The clamp keeps an out-of-range value from wrapping."""
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def _shift_resample(x, t_float, dim, nbits):
    """1-D linear resample: out[i] = lerp(x[i + t]) via a barrel shift by
    floor(t) and one +1 neighbour. Integer inputs lerp in fp32 and round back
    half up; the multiplies and adds are separate operations (no FMA)."""
    t0 = torch.floor(t_float)
    frac = t_float - t0
    x0 = _barrel_shift(x, t0.to(torch.int64), dim, nbits)
    x1 = torch.roll(x0, -1, dims=dim)
    if not x.is_floating_point():
        frac = frac.float()
        out = (1.0 - frac) * x0.float() + frac * x1.float()
        return to_uint8(out + 0.5)
    frac = frac.to(x.dtype)
    return (1.0 - frac) * x0 + frac * x1


def crop_batch_planes(x, r, c, out_hw):
    """x (B,C,H,W), integer per-image origins r, c (B,) -> (B,C,oh,ow)."""
    oh, ow = out_hw
    H, W = x.shape[2], x.shape[3]
    if H > oh:
        x = _barrel_shift(x, r.view(-1, 1, 1, 1), 2, int(H - oh).bit_length())[:, :, :oh]
    if W > ow:
        x = _barrel_shift(x, c.view(-1, 1, 1, 1), 3, int(W - ow).bit_length())[:, :, :, :ow]
    return x[:, :, :oh, :ow]


def _bgr_to_hsv_chw(im):
    """cv2-convention HSV of float BGR planes im (3, ...): H in [0, 180),
    S and V in [0, 255]. Ties between channels resolve as v == r first,
    then v == g."""
    if not im.is_floating_point():
        im = im.float()
    b, g, r = im[0], im[1], im[2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    sat = torch.where(v == 0, torch.zeros_like(v),
                      255.0 * diff / torch.where(v == 0, torch.ones_like(v), v))
    return h, sat, v


def _hsv_to_bgr_chw(h, s, v):
    """The inverse: planes (3, ...) in BGR order. hp = 2h/60 lies in [0, 6)
    for h <= 179; fmod is the floor-mod there."""
    h2, s2 = h * 2.0, s * _INV_255
    c = v * s2
    hp = h2 * _INV_60
    x = c * (1.0 - torch.abs(torch.fmod(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.clamp(torch.floor(hp).to(torch.int64), 0, 5)

    def sel(vals):
        out = vals[5]
        for i in range(4, -1, -1):
            out = torch.where(idx == i, vals[i], out)
        return out

    r = sel([c, x, z, z, x, c])
    g = sel([x, c, c, x, z, z])
    b = sel([z, z, x, c, c, x])
    m = v - c
    return torch.stack([b + m, g + m, r + m], dim=0)


def hsv_batch_planes(x, scales):
    """HSV perturbation of float (B,3,H,W) BGR planes by per-image scales
    (B,3), with the H <= 179 clip; returns float planes in [0, 255]."""
    h, s, v = _bgr_to_hsv_chw(x.movedim(1, 0))
    sh, ss, sv = (scales[:, i].view(-1, 1, 1).to(h.dtype) for i in range(3))
    h = torch.clamp(h * sh, 0.0, 179.0)
    s = torch.clamp(s * ss, 0.0, 255.0)
    v = torch.clamp(v * sv, 0.0, 255.0)
    return torch.clamp(_hsv_to_bgr_chw(h, s, v).movedim(0, 1), 0.0, 255.0)


def shear_pad(rotation_tuple, H, W):
    """Zero margin covering the largest shear displacement of the angle
    range; the shifts of content lines then lie in [2, 2P-2]."""
    max_t = max(abs(rotation_tuple[0]), abs(rotation_tuple[1])) * math.pi / 180.0
    return int(math.ceil(max(math.tan(max_t / 2.0), math.sin(max_t))
                         * max(H, W) / 2.0)) + 2


def shear_coefs(deg):
    """The three-shear coefficients of angles ``deg`` (B,) fp32: a =
    -tan(theta/2) and b = sin(theta), theta = deg * (pi/180) in fp32. The
    tangent and sine are taken in fp64 of the fp32 theta and rounded to fp32,
    so every device gets the same values."""
    theta = (deg.float() * _DEG_TO_RAD).double()
    return (-torch.tan(theta * 0.5)).float(), torch.sin(theta).float()


def shear_rotate_planes(x, a, b, P):
    """The three-shear rotation of (B,C,H,W) planes by per-image
    coefficients a, b (B,) fp32 (``shear_coefs``) with zero margin P.

    Each shear is out[i] = lerp(in[i + t]), t = coef * (coord - centre) + P,
    over the planes padded by P, statically rolled by +P and barrel-shifted
    by t clipped to [0, 2**nbits - 1]; reads wrap modulo the padded length.
    The first shear (along W) runs over all H + 2P rows, the second (along
    H) over all W + 2P columns and keeps rows P:P+H, the third (along W)
    keeps columns P:P+W."""
    B, C, H, W = x.shape
    cy, cx = H / 2.0, W / 2.0
    nbits = int(2 * P - 2).bit_length()
    t_hi = float((1 << nbits) - 1)
    dev = x.device
    x = torch.nn.functional.pad(x, (P, P, P, P))
    x_orig = torch.arange(W + 2 * P, dtype=torch.float32, device=dev) - P

    def shear_w(img, coef, y_coords):  # in_x = out_x + coef * (y - cy)
        t = coef.view(-1, 1, 1, 1) * (y_coords - cy).view(1, 1, -1, 1) + P
        return _shift_resample(torch.roll(img, P, dims=3), torch.clamp(t, 0.0, t_hi), 3, nbits)

    def shear_h(img, coef):  # in_y = out_y + coef * (x - cx)
        t = coef.view(-1, 1, 1, 1) * (x_orig - cx).view(1, 1, 1, -1) + P
        return _shift_resample(torch.roll(img, P, dims=2), torch.clamp(t, 0.0, t_hi), 2, nbits)

    y_pad = torch.arange(H + 2 * P, dtype=torch.float32, device=dev) - P
    y_content = torch.arange(H, dtype=torch.float32, device=dev)
    x = shear_w(x, a, y_pad)
    x = shear_h(x, b)[:, :, P:P + H]
    x = shear_w(x, a, y_content)
    return x[:, :, :, P:P + W]


def rotate_batch_planes(x, deg, rotation_tuple):
    """Per-image three-shear rotation of (B,C,H,W) planes by angles ``deg``
    (B,), with the margin of ``rotation_tuple``'s largest angle."""
    a, b = shear_coefs(deg)
    return shear_rotate_planes(x, a, b, shear_pad(rotation_tuple, x.shape[2], x.shape[3]))


def flip_batch_planes(x, do):
    """Per-image horizontal flip of (B,C,H,W) where ``do`` (B,) is true."""
    return torch.where(do.view(-1, 1, 1, 1), x.flip(-1), x)
