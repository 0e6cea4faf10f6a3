"""Packed pre-decoded dataset, the read side (counterpart of
``dorknet_tpu/data_loading/packed_dataset.py``).

A packed directory holds

* ``images.npy``: (N, precrop_h, precrop_w, 3) uint8 BGR canvases, read
  back memory-mapped;
* ``labels.npy``: (N,) int32 labels in sorted-class-name order;
* ``packed_meta.json``: the format tag, the precrop size, the class names
  and the source path of every row, in pack order (classes sorted by name,
  paths sorted within a class), so that a packed loader draws the same
  sample sequence as a loader over the source tree.

Directories written by either package read here. ``write_packed_arrays``
writes one from arrays already decoded; packing a JPEG tree
(``write_packed_dataset``, which decodes with cv2 or the native loader) is
not ported (ROADMAP A5b).
"""

import json
import os

import numpy as np

PACKED_META = "packed_meta.json"
PACKED_FORMAT = "dorknet-packed-v1"


def is_packed_dir(path):
    """True if ``path`` is a packed-dataset directory."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, PACKED_META))


def write_packed_arrays(out_dir, images, labels, class_names):
    """Write a packed directory from decoded canvases: images (N, h, w, 3)
    uint8 (an array, or a callable ``images(start, stop)`` giving rows
    start:stop, for data made in pieces), labels (N,) ints and class_names
    in label order; row i's path is ``<class>/images/<i>.png``. Rows must be
    in pack order: labels ascending. Returns N."""
    labels = np.asarray(labels, dtype=np.int32)
    n = len(labels)
    if n and np.any(np.diff(labels) < 0):
        raise ValueError("rows must be in pack order (labels ascending)")
    rows = images if callable(images) else (lambda a, b: images[a:b])
    first = np.asarray(rows(0, min(n, 1)))
    if first.dtype != np.uint8 or first.ndim != 4 or first.shape[3] != 3:
        raise ValueError("images must be (N, h, w, 3) uint8, got {} {}".format(
            first.dtype, first.shape))
    h, w = first.shape[1:3]
    paths = [os.path.join(class_names[int(l)], "images", "{:06d}.png".format(i))
             for i, l in enumerate(labels)]
    os.makedirs(out_dir, exist_ok=True)
    out = np.lib.format.open_memmap(os.path.join(out_dir, "images.npy"), mode="w+",
                                    dtype=np.uint8, shape=(n, h, w, 3))
    step = max(1, (64 << 20) // max(1, h * w * 3))
    for start in range(0, n, step):
        out[start:start + step] = rows(start, min(n, start + step))
    out.flush()
    del out
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    meta = {"format": PACKED_FORMAT, "precrop": [int(h), int(w)],
            "class_names": list(class_names), "paths": paths, "source": ""}
    with open(os.path.join(out_dir, PACKED_META), "w") as f:
        json.dump(meta, f)
    return n


class PackedDataset:
    """Read side of a packed directory: memory-mapped image rows, labels,
    and the class and path index the loader samples from."""

    def __init__(self, path):
        with open(os.path.join(path, PACKED_META)) as f:
            meta = json.load(f)
        if meta.get("format") != PACKED_FORMAT:
            raise ValueError("{} is not a {} directory (format={!r})".format(
                path, PACKED_FORMAT, meta.get("format")))
        self.path = path
        self.precrop = tuple(meta["precrop"])  # (h, w)
        self.class_names = list(meta["class_names"])
        self.paths = list(meta["paths"])
        self.labels = np.load(os.path.join(path, "labels.npy"))
        self.images = np.load(os.path.join(path, "images.npy"), mmap_mode="r")
        n = len(self.paths)
        if not (self.images.shape[0] == n == self.labels.shape[0]):
            raise ValueError(
                "packed dataset {} is inconsistent: {} paths, {} rows, {} labels".format(
                    path, n, self.images.shape[0], self.labels.shape[0]))
        # per-class row lists in pack order: the sequence the source tree's
        # sorted listing gives, so both loaders draw the same samples
        self.per_class_rows = {name: [] for name in self.class_names}
        for row, label in enumerate(self.labels):
            self.per_class_rows[self.class_names[int(label)]].append(row)

    def __len__(self):
        return len(self.paths)

    def gather(self, rows):
        """(B,) row indices -> (B, ph, pw, 3) uint8 batch (a copy)."""
        return self.images[np.asarray(rows, dtype=np.int64)]
