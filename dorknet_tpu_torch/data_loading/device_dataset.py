"""A dataset resident in device memory (counterpart of
``dorknet_tpu/data_loading/device_dataset.py``).

The packed dataset is uploaded to the card once; each training step then
moves only a (B,) row-index vector from the host, and the gather, one-hot,
augmentation and step run on the card (``Trainer.step_augmented_indexed``).
The sampling protocol (shuffle, class balance, ``data_shard``) stays on the
host in a thread-less ``ImageDataLoader``, so this dataset and a streaming
loader over the same directory draw the same rows under the same numpy
seed.

Upload: the (N, ph, pw, 3) uint8 tensor is allocated on the device once,
and chunks of ``chunk_bytes`` are copied into its slices from two pinned
host staging buffers in turn, so the device holds the dataset and nothing
else of its size, and reading the next chunk from the memory map overlaps
the copy of the last.
"""

import json
import os

import numpy as np
import torch

from dorknet_tpu_torch.data_loading.image_data_loader import ImageDataLoader
from dorknet_tpu_torch.data_loading.packed_dataset import PACKED_META
from dorknet_tpu_torch.network.inference import resolve_device

_DEFAULT_CHUNK_BYTES = 64 << 20


def fits_in_hbm(packed, budget_bytes=None):
    """Advisory: True when ``packed``'s image array fits ``budget_bytes``,
    by default half of the current card's total memory (the rest is for the
    model, the optimiser state and the step's working set)."""
    if budget_bytes is None:
        budget_bytes = torch.cuda.get_device_properties("cuda").total_memory // 2
    return packed.images.nbytes <= budget_bytes


class DeviceResidentDataset:
    """A packed dataset uploaded to device memory once, with the host-side
    index sampler that drives ``Trainer.step_augmented_indexed``.

    ``images``: (N, ph, pw, 3) uint8 on the device; ``labels``: (N,) int32
    on the device; ``next_indices()`` draws one (B,) int32 numpy row-index
    batch with the protocol of an ``ImageDataLoader`` over the directory.
    device: where the dataset lives, the card unless the caller asks for the
    CPU."""

    def __init__(self, packed_path, batch_size, class_balance=True, data_shard=None,
                 device="cuda", chunk_bytes=_DEFAULT_CHUNK_BYTES, expect_precrop=None):
        with open(os.path.join(packed_path, PACKED_META)) as f:
            ph, pw = json.load(f)["precrop"]
        if expect_precrop is not None and tuple(expect_precrop) != (ph, pw):
            raise ValueError(
                "packed dataset {} holds {}-pixel canvases but expect_precrop={}; "
                "repack it (a stale pack from another image size trains with the "
                "wrong crop geometry)".format(packed_path, (ph, pw), tuple(expect_precrop)))
        self.device = resolve_device(device, "DeviceResidentDataset")
        self._sampler = ImageDataLoader(packed_path, batch_size, class_balance=class_balance,
                                        data_shard=data_shard, start_thread=False)
        self.packed = self._sampler.packed
        self._row_of = self._sampler._packed_row
        self.batch_size = int(batch_size)
        self.num_classes = len(self.packed.class_names)
        self.class_names = list(self.packed.class_names)
        self.images = self._upload(self.packed.images, int(chunk_bytes))
        self.labels = torch.from_numpy(
            np.ascontiguousarray(self.packed.labels, dtype=np.int32)).to(self.device)

    def _upload(self, src, chunk_bytes):
        """Copy the memory-mapped rows into one device tensor, chunk by chunk
        through two staging buffers (pinned on the card's host)."""
        out = torch.empty(src.shape, dtype=torch.uint8, device=self.device)
        n = len(src)
        if n == 0:
            return out
        rows = max(1, chunk_bytes // max(1, src[0].nbytes))
        pin = self.device.type == "cuda"
        staging = [torch.empty((min(rows, n),) + src.shape[1:], dtype=torch.uint8,
                               pin_memory=pin) for _ in range(2)]
        done = [None, None]  # the copy last made from each staging buffer
        for k, start in enumerate(range(0, n, rows)):
            stop = min(n, start + rows)
            buf = staging[k % 2]
            if done[k % 2] is not None:
                done[k % 2].synchronize()
            buf[:stop - start].numpy()[...] = src[start:stop]
            out[start:stop].copy_(buf[:stop - start], non_blocking=pin)
            if pin:
                done[k % 2] = torch.cuda.Event()
                done[k % 2].record(torch.cuda.current_stream(self.device))
        if pin:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def __len__(self):
        return len(self.packed)

    def next_indices(self):
        """One (B,) int32 row-index draw (the streaming loader's
        get_batch_list under the same numpy RNG state)."""
        paths, _ = self._sampler.get_batch_list(self._sampler.class_balance)
        return np.fromiter((self._row_of[p] for p in paths), dtype=np.int32,
                           count=len(paths))

    def pull_indices(self, num_steps):
        for _ in range(int(num_steps)):
            yield self.next_indices()

    def shuffle_indices(self):
        """Reshuffle the flat index cycle (reference epoch protocol)."""
        self._sampler.shuffle_indices()
