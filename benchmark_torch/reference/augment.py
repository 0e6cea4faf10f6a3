"""The plain training augmentation of uint8 BGR canvases, and its draws.

The augmentation the flagship trains with: a random crop, an HSV
perturbation in OpenCV's conventions (HSV in fp32, rounded half up to uint8),
a rotation by three shears (each shear a linear resample, rounded half up to
uint8), a horizontal flip, the -128 shift, and the paired mixup that trains
both convex combinations of each image with a permuted partner. The
arithmetic is a copy of the published plain planes algorithm (crop by
barrel shifts, the cv2-matched HSV round trip, the three shears over a
zero margin), in plain PyTorch over (B, C, H, W) planes.

``draw`` takes the per-image parameters from a ``torch.Generator`` in the
order and with the distributions the model's augmentation specifies: crop
origins uniform over [0, precrop - out), HSV scales uniform over their
ranges, angles uniform over the rotation range, flips with their
probability, then the mixup weight uniform over its range and a permutation
of the batch. Given a generator seeded as the trained run's, the draws are
the run's draws.
"""

import math

import numpy as np
import torch

_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_60 = float(np.float32(1.0) / np.float32(60.0))
_DEG_TO_RAD = float(np.float32(np.pi) * (np.float32(1.0) / np.float32(180.0)))


def draw(generator, batch, precrop_hw, out_hw, aug):
    """The per-image draws of one step, on the generator's device."""
    dev = generator.device
    p = {}
    p["r"] = torch.randint(0, max(precrop_hw[0] - out_hw[0], 1), (batch,),
                           generator=generator, device=dev)
    p["c"] = torch.randint(0, max(precrop_hw[1] - out_hw[1], 1), (batch,),
                           generator=generator, device=dev)
    u = torch.rand((batch, 3), generator=generator, device=dev)
    bounds = [(np.float32(lo), np.float32(hi)) for lo, hi in aug["hsv_pert_tuples"]]
    p["hsv"] = torch.stack([u[:, i] * float(hi - lo) + float(lo)
                            for i, (lo, hi) in enumerate(bounds)], dim=1)
    lo, hi = float(aug["rotation_tuple"][0]), float(aug["rotation_tuple"][1])
    p["deg"] = torch.rand((batch,), generator=generator, device=dev) * (hi - lo) + lo
    p["flip"] = torch.rand((batch,), generator=generator, device=dev) < \
        aug["horizontal_flip_prob"]
    return p


def draw_mixup(generator, batch, lo, hi):
    dev = generator.device
    lam = torch.rand((), generator=generator, device=dev) * (float(hi) - float(lo)) + float(lo)
    return lam, torch.randperm(batch, generator=generator, device=dev)


def _barrel_shift(x, t, dim, nbits):
    for j in range(nbits):
        rolled = torch.roll(x, -(1 << j), dims=dim)
        x = torch.where(((t >> j) & 1).bool(), rolled, x)
    return x


def _to_uint8(v):
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def _shift_resample(x, t_float, dim, nbits):
    t0 = torch.floor(t_float)
    frac = (t_float - t0).float()
    x0 = _barrel_shift(x, t0.to(torch.int64), dim, nbits)
    x1 = torch.roll(x0, -1, dims=dim)
    return _to_uint8((1.0 - frac) * x0.float() + frac * x1.float() + 0.5)


def _crop(x, r, c, out_hw):
    oh, ow = out_hw
    H, W = x.shape[2], x.shape[3]
    if H > oh:
        x = _barrel_shift(x, r.view(-1, 1, 1, 1), 2, int(H - oh).bit_length())[:, :, :oh]
    if W > ow:
        x = _barrel_shift(x, c.view(-1, 1, 1, 1), 3, int(W - ow).bit_length())[:, :, :, :ow]
    return x[:, :, :oh, :ow]


def _bgr_to_hsv(im):
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


def _hsv_to_bgr(h, s, v):
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


def _hsv(x, scales):
    h, s, v = _bgr_to_hsv(x.movedim(1, 0))
    sh, ss, sv = (scales[:, i].view(-1, 1, 1) for i in range(3))
    h = torch.clamp(h * sh, 0.0, 179.0)
    s = torch.clamp(s * ss, 0.0, 255.0)
    v = torch.clamp(v * sv, 0.0, 255.0)
    return torch.clamp(_hsv_to_bgr(h, s, v).movedim(0, 1), 0.0, 255.0)


def shear_pad(rotation_tuple, H, W):
    """The zero margin that covers the range's largest shear."""
    max_t = max(abs(rotation_tuple[0]), abs(rotation_tuple[1])) * math.pi / 180.0
    return int(math.ceil(max(math.tan(max_t / 2.0), math.sin(max_t))
                         * max(H, W) / 2.0)) + 2


def _rotate(x, deg, P):
    theta = (deg.float() * _DEG_TO_RAD).double()
    a, b = (-torch.tan(theta * 0.5)).float(), torch.sin(theta).float()
    B, C, H, W = x.shape
    cy, cx = H / 2.0, W / 2.0
    nbits = int(2 * P - 2).bit_length()
    t_hi = float((1 << nbits) - 1)
    dev = x.device
    x = torch.nn.functional.pad(x, (P, P, P, P))
    x_orig = torch.arange(W + 2 * P, dtype=torch.float32, device=dev) - P

    def shear_w(img, coef, y_coords):
        t = coef.view(-1, 1, 1, 1) * (y_coords - cy).view(1, 1, -1, 1) + P
        return _shift_resample(torch.roll(img, P, dims=3), torch.clamp(t, 0.0, t_hi), 3, nbits)

    def shear_h(img, coef):
        t = coef.view(-1, 1, 1, 1) * (x_orig - cx).view(1, 1, 1, -1) + P
        return _shift_resample(torch.roll(img, P, dims=2), torch.clamp(t, 0.0, t_hi), 2, nbits)

    y_pad = torch.arange(H + 2 * P, dtype=torch.float32, device=dev) - P
    y_content = torch.arange(H, dtype=torch.float32, device=dev)
    x = shear_w(x, a, y_pad)
    x = shear_h(x, b)[:, :, P:P + H]
    x = shear_w(x, a, y_content)
    return x[:, :, :, P:P + W]


def augment(canvases, p, out_hw, aug):
    """uint8 (B, H, W, 3) canvases -> uint8 (B, 3, oh, ow) planes."""
    x = _crop(canvases.permute(0, 3, 1, 2), p["r"], p["c"], out_hw)
    x = _to_uint8(_hsv(x.float(), p["hsv"]) + 0.5)
    x = _rotate(x, p["deg"], shear_pad(aug["rotation_tuple"], *out_hw))
    return torch.where(p["flip"].view(-1, 1, 1, 1), x.flip(-1), x)


def train_batch(generator, canvases, one_hot, out_hw, aug, mixup):
    """The trained batch of one step: (2B, 3, oh, ow) fp32 images and
    (2B, classes) fp32 labels, drawing from ``generator`` as the model's
    augmentation does (the per-image draws, then the mixup's)."""
    B, H, W = canvases.shape[:3]
    p = draw(generator, B, (H, W), out_hw, aug)
    x = augment(canvases, p, out_hw, aug).float() - 128.0
    lam, perm = draw_mixup(generator, B, mixup[0], mixup[1])
    xm, ym = x[perm], one_hot[perm]
    x_a = lam * xm + (1 - lam) * x
    x_b = lam * x + (1 - lam) * xm
    y_a = lam * ym + (1 - lam) * one_hot
    y_b = lam * one_hot + (1 - lam) * ym
    return torch.cat([x_a, x_b]), torch.cat([y_a, y_b])
