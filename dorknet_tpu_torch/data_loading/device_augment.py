"""On-device augmentation, the planes path (counterpart of the batched half of
``dorknet_tpu/data_loading/device_augment.py``).

A training batch arrives as precrop-size BGR images, (B, H, W, 3) uint8 as
the loader and ``DeviceResidentDataset`` hold them. ``train_pipeline`` crops
them to the output size, perturbs HSV, rotates, flips, shifts by -128 and
mixes up, all on the batch's device. For uint8 batches the whole
augmentation is one call of ``ops/cuda/augment.py:augment_planes_fused``: on
the card a hand-written CUDA kernel, on the CPU its plain version.

The random draws are split from the arithmetic. ``draw_batch_params`` and
``draw_mixup`` take an explicit ``torch.Generator`` and draw on its device;
every other function takes the draws as tensors, so a test can hand the JAX
package's own draws to both packages. Nothing here copies from the host or
waits on the card, so ``Trainer`` captures the pipeline into the CUDA graph
of its augmented step; the graph advances the caller's generator at every
replay, as the eager draws do.

The arithmetic is the JAX package's planes path: crop, cv2-matched HSV in
fp32, the three-shear rotation with fp32 lerps and round-half-up back to
uint8 after every stage, then the flip. Its stages live in ``ops/augment.py``
and are re-exported here; ``augment_batch_planes`` chains them for float
batches.

The per-image HWC/CHW oracle paths (``augment_image``, ``augment_batch``,
``internal_layout`` "HWC"/"CHW") are not ported (ROADMAP A5).
"""

import numpy as np
import torch

from dorknet_tpu_torch.config import get_compute_dtype
from dorknet_tpu_torch.ops.augment import (  # noqa: F401 (the planes stages, re-exported)
    _bgr_to_hsv_chw, _hsv_to_bgr_chw, crop_batch_planes, flip_batch_planes, hsv_batch_planes,
    rotate_batch_planes, shear_coefs, shear_pad, shear_rotate_planes, to_uint8)
from dorknet_tpu_torch.ops.cuda.augment import augment_planes_fused


# --------------------------------------------------------------------- #
# Draws
# --------------------------------------------------------------------- #
def draw_batch_params(generator, batch, precrop_hw, out_hw, hsv_pert_tuples=None,
                      rotation_tuple=None, horizontal_flip_prob=None,
                      crop_mode="random"):
    """Per-image augmentation parameters as (B,) tensors on the generator's
    device, from the JAX package's distributions: crop origins uniform over
    [0, max(precrop - out, 1)), HSV scales and angles uniform over their
    ranges, flips with probability ``horizontal_flip_prob``. Only the
    configured stages draw."""
    dev = generator.device
    p = {}
    if crop_mode == "random":
        p["crop_r"] = torch.randint(0, max(precrop_hw[0] - out_hw[0], 1), (batch,),
                                    generator=generator, device=dev)
        p["crop_c"] = torch.randint(0, max(precrop_hw[1] - out_hw[1], 1), (batch,),
                                    generator=generator, device=dev)
    if hsv_pert_tuples is not None:
        u = torch.rand((batch, 3), generator=generator, device=dev)
        # u * (hi - lo) + lo per channel, hi - lo rounded in fp32: Python
        # scalars, since a host list copied to the card cannot be captured
        # into a CUDA graph
        bounds = [(np.float32(lo), np.float32(hi)) for lo, hi in hsv_pert_tuples]
        p["hsv_scales"] = torch.stack([u[:, i] * float(hi - lo) + float(lo)
                                       for i, (lo, hi) in enumerate(bounds)], dim=1)
    if rotation_tuple is not None:
        lo, hi = float(rotation_tuple[0]), float(rotation_tuple[1])
        u = torch.rand((batch,), generator=generator, device=dev)
        p["deg"] = u * (hi - lo) + lo
    if horizontal_flip_prob is not None:
        p["flip"] = torch.rand((batch,), generator=generator, device=dev) < horizontal_flip_prob
    return p


def draw_mixup(generator, batch, lo, hi):
    """The mixup draws on the generator's device: lam, a 0-dim fp32 tensor
    uniform over [lo, hi), and perm, a permutation of the batch."""
    dev = generator.device
    lam = torch.rand((), generator=generator, device=dev) * (float(hi) - float(lo)) + float(lo)
    perm = torch.randperm(batch, generator=generator, device=dev)
    return lam, perm


def augment_batch_planes(x, params, out_hw, hsv_pert_tuples=None, rotation_tuple=None,
                         horizontal_flip_prob=None, crop_mode="random", hsv_dtype=None):
    """Crop -> HSV -> rotate -> flip of (B,C,H,W) planes by ``params``
    (``draw_batch_params``), in the input dtype. Integer inputs run HSV in
    fp32 and round back to the input dtype after it (``hsv_dtype`` is then
    ignored); float inputs run HSV in ``hsv_dtype`` (default: x's)."""
    quantise = not x.is_floating_point()
    if quantise:
        hsv_dtype = torch.float32
    elif hsv_dtype is None:
        hsv_dtype = x.dtype
    if crop_mode == "random":
        x = crop_batch_planes(x, params["crop_r"], params["crop_c"], out_hw)
    elif crop_mode == "center":
        H, W = x.shape[2], x.shape[3]
        r0, c0 = (H - out_hw[0]) // 2, (W - out_hw[1]) // 2
        x = x[:, :, r0:r0 + out_hw[0], c0:c0 + out_hw[1]]
    if hsv_pert_tuples is not None:
        hsv = hsv_batch_planes(x.to(hsv_dtype), params["hsv_scales"])
        x = to_uint8(hsv + 0.5).to(x.dtype) if quantise else hsv
    if rotation_tuple is not None:
        x = rotate_batch_planes(x, params["deg"], rotation_tuple)
    if horizontal_flip_prob is not None:
        x = flip_batch_planes(x, params["flip"])
    return x


def mixup_pair(X, one_hot, lam, perm):
    """The reference's paired mixup from the draws of ``draw_mixup``: the
    batch permuted by perm is the partner, and both convex combinations are
    returned, (2B, ...) images and labels. lam is cast to the images' dtype
    for the images (a bf16 batch stays bf16); the labels mix in fp32."""
    Xm, ym = X[perm], one_hot[perm]
    lam_x = lam.to(X.dtype)
    X_a = lam_x * Xm + (1 - lam_x) * X
    X_b = lam_x * X + (1 - lam_x) * Xm
    y_a = lam * ym + (1 - lam) * one_hot
    y_b = lam * one_hot + (1 - lam) * ym
    return torch.cat([X_a, X_b]), torch.cat([y_a, y_b])


def train_pipeline(generator, images_precrop, one_hot, out_hw, hsv_pert_tuples=None,
                   rotation_tuple=None, horizontal_flip_prob=None, crop_mode="random",
                   mixup=None, output_layout="NCHW", internal_layout="planes"):
    """Precrop-size BGR batch (B,H,W,3) in [0, 255] -> augmented, optionally
    mixed-up, -128-shifted training batch, all on the batch's device.

    generator: a ``torch.Generator`` on that device; the augmentation draws
    come first, then the mixup draws. uint8 batches go through
    ``augment_planes_fused`` (the CUDA kernel on the card); float batches run
    the planes path here on the CPU, and raise on the card. The emitted batch
    and the mixup are in the compute dtype (``config.set_compute_dtype``).
    output_layout "NHWC" pairs with
    ``Trainer(input_layout="NHWC")``. Returns (x, one_hot), 2B rows each
    with mixup."""
    if internal_layout != "planes":
        raise NotImplementedError(
            "internal_layout={!r}: only the planes path is ported; the per-image "
            "HWC/CHW oracle paths are ROADMAP A5".format(internal_layout))
    if output_layout not in ("NCHW", "NHWC"):
        raise ValueError("output_layout must be 'NCHW' or 'NHWC', got {!r}".format(
            output_layout))
    aug_dtype = get_compute_dtype()
    B, H, W = images_precrop.shape[:3]
    params = draw_batch_params(generator, B, (H, W), out_hw, hsv_pert_tuples,
                               rotation_tuple, horizontal_flip_prob, crop_mode)
    if images_precrop.dtype == torch.uint8 or images_precrop.device.type != "cpu":
        # a float batch on the card raises there: the kernel is uint8-only
        x = augment_planes_fused(images_precrop, params, out_hw, hsv_pert_tuples,
                                 rotation_tuple, horizontal_flip_prob, crop_mode)
    else:
        x = augment_batch_planes(images_precrop.permute(0, 3, 1, 2), params, out_hw,
                                 hsv_pert_tuples, rotation_tuple, horizontal_flip_prob,
                                 crop_mode, hsv_dtype=aug_dtype)
    x = x.to(aug_dtype) - 128.0
    if mixup is not None:
        lam, perm = draw_mixup(generator, x.shape[0], mixup[0], mixup[1])
        x, one_hot = mixup_pair(x, one_hot, lam, perm)
    if output_layout == "NHWC":
        x = x.permute(0, 2, 3, 1)
    return x.contiguous(), one_hot
