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
"""

import ctypes

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
                        "ROADMAP A5b".format(x.dtype))
    if not x.is_contiguous():
        raise ValueError("augment_planes_fused: x must be contiguous")


def smem_bytes(oh, ow, P):
    """Dynamic shared memory of one block of the rotating kernel: two uint8
    stage buffers of oh x (ow + 2P), padded to 4 bytes, and an int and a
    float shift for each of the oh rows and ow + 2P columns. The kernel
    without rotation uses none."""
    if not P:
        return 0
    Wp = ow + 2 * P
    return ((2 * oh * Wp + 3) & ~3) + 8 * (oh + Wp)


def augment_planes_fused(x, params, out_hw, hsv_pert_tuples=None, rotation_tuple=None,
                         horizontal_flip_prob=None, crop_mode="random"):
    """Crop -> HSV -> rotate -> flip of a uint8 (B,H,W,3) BGR batch by
    ``params`` (``draw_batch_params``), as the JAX package's
    ``augment_batch_planes`` computes it for uint8 planes. Returns (B,3,oh,ow)
    uint8 ((B,3,H,W) with crop_mode None). On a CUDA tensor: one kernel
    launch, or an error (a float batch, or a rotation whose two stage buffers
    exceed a block's shared memory)."""
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


def launch_augment_kernel(x, table, out_hw, hsv_on, P):
    """The kernel alone, on a CUDA batch x (B,H,W,3) uint8 and the table of
    ``augment_param_table`` on the same device: returns (B,3,oh,ow) uint8.
    Raises rather than launch when a rotation's stage buffers exceed a
    block's shared memory. Counts the launch in
    ``augment_planes_fused.launches``."""
    if x.device.type != "cuda" or table.device != x.device:
        raise ValueError("augment_planes_fused: the kernel needs x and the table on one "
                         "CUDA device, got {} and {}".format(x.device, table.device))
    B, H, W = x.shape[:3]
    oh, ow = out_hw
    out = torch.empty((B, 3, oh, ow), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    kernels = load_library()
    smem = smem_bytes(oh, ow, P)
    limit = kernels.lib.dorknet_max_block_smem(x.device.index)
    if limit < 0:
        check(kernels.lib, -limit, "augment_planes_fused shared-memory query")
    if smem > limit:
        raise ValueError(
            "augment_planes_fused: rotating {}x{} needs {} bytes of shared memory a "
            "block (two {}x{} uint8 stages and the line shifts), more than the {} a "
            "block of this card can have".format(oh, ow, smem, oh, ow + 2 * P, limit))
    nbits = int(2 * P - 2).bit_length() if P else 0
    err = kernels.lib.dorknet_augment_planes(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), B, H, W, oh, ow, P,
        ctypes.c_float(float((1 << nbits) - 1)), int(hsv_on), _stream(x), x.device.index)
    check(kernels.lib, err, "augment_planes_fused launch")
    augment_planes_fused.launches += 1
    return out


augment_planes_fused.launches = 0
