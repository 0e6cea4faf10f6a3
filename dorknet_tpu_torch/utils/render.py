"""Drawing a CAM without cv2 (numpy and ``zlib`` only): the JET colormap of
``cv2.applyColorMap(..., cv2.COLORMAP_JET)`` and a PNG writer that stands
in for ``cv2.imwrite`` on uint8 images, both in cv2's BGR channel order."""

import struct
import zlib

import numpy as np


def _jet_table():
    """(256, 3) uint8 BGR: cv2's JET, level by level. Each channel rises and
    falls by 4 a level, clipped to [0, 255]; cv2's table holds 1, not 2, at
    level 159 of the blue ramp."""
    i = np.arange(256)
    ramps = [(128, 638), (-128, 892), (-382, 1148)]  # B, G, R: up 4i + a, down c - 4i
    table = np.stack([np.clip(np.minimum(4 * i + a, c - 4 * i), 0, 255) for a, c in ramps], 1)
    table[159, 0] = 1
    return table.astype(np.uint8)


JET_BGR = _jet_table()


def apply_jet(gray):
    """uint8 (H, W) -> (H, W, 3) uint8 BGR, as ``cv2.applyColorMap(gray,
    cv2.COLORMAP_JET)``."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise TypeError("apply_jet takes uint8 levels, got {}".format(gray.dtype))
    return JET_BGR[gray]


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img):
    """Write a uint8 image, (H, W) gray or (H, W, 3) BGR as cv2 holds it,
    as an 8-bit PNG (no filtering, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("write_png takes uint8 (H, W) or (H, W, 3), got {} {}".format(
            img.dtype, img.shape))
    color = img.ndim == 3
    rows = img[:, :, ::-1] if color else img  # PNG stores RGB
    h, w = img.shape[:2]
    raw = np.empty((h, 1 + w * (3 if color else 1)), np.uint8)
    raw[:, 0] = 0  # filter type None on every row
    raw[:, 1:] = rows.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if color else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
