"""The image loader's sampling protocol over a packed directory (counterpart
of ``dorknet_tpu/data_loading/image_data_loader.py``).

What is ported is what ``DeviceResidentDataset`` needs: the packed-mode
state, ``data_shard`` striding, the empty-class checks, ``shuffle_indices``
and ``get_batch_list``. The draws are the JAX package's: class-balanced
round-robin over per-class path cycles, or a flat index cycle over all
samples that ``shuffle_indices`` reshuffles with ``np.random.permutation``,
so under the same numpy seed both packages draw the same rows.

The threaded producer (decode, ``load_batch``, ``pull_batch``, host mixup)
and loading a JPEG tree are not ported (ROADMAP A5b): constructing with
``start_thread=True`` or over a directory that is not packed raises
``NotImplementedError``.
"""

import itertools
import sys

import numpy as np

from dorknet_tpu_torch.data_loading.packed_dataset import PackedDataset, is_packed_dir

_NOT_PORTED = ("the threaded streaming loader with decode is not ported yet "
               "(ROADMAP A5b); use a packed directory with start_thread=False, "
               "e.g. through DeviceResidentDataset")


def default_precrop(image_size):
    """The reference's 1.25x pre-crop canvas for a given output size."""
    return (int(image_size[0] * 1.25), int(image_size[1] * 1.25))


class ImageDataLoader:
    def __init__(self, base_folder, batch_size, class_balance=True, start_thread=True,
                 data_shard=None):
        """A sampler over the packed directory ``base_folder``.
        data_shard=(index, count) keeps every count-th path of each class's
        sorted list, from index, so the shards are disjoint and together cover
        the dataset; labels come from the full class list."""
        if start_thread:
            raise NotImplementedError("ImageDataLoader(start_thread=True): " + _NOT_PORTED)
        if not is_packed_dir(base_folder):
            raise NotImplementedError(
                "ImageDataLoader over {}, which is not a packed directory: {}".format(
                    base_folder, _NOT_PORTED))
        self.batch_size = batch_size
        self.class_balance = class_balance

        self.packed = PackedDataset(base_folder)
        self._packed_row = {p: i for i, p in enumerate(self.packed.paths)}
        self.class_name_num_map = {name: label for label, name in
                                   enumerate(self.packed.class_names)}
        per_class_paths = {name: [self.packed.paths[r] for r in rows]
                           for name, rows in self.packed.per_class_rows.items()}
        self.samples = [(name, path) for name in self.packed.class_names
                        for path in per_class_paths[name]]
        self.class_names = list(self.class_name_num_map)
        if data_shard is not None:
            shard_idx, shard_count = data_shard
            if not (isinstance(shard_idx, int) and isinstance(shard_count, int)
                    and shard_count >= 1 and 0 <= shard_idx < shard_count):
                raise ValueError(
                    "data_shard must be (process_index, process_count) with "
                    "0 <= index < count, got {!r}".format(data_shard))
            per_class_paths = {n: p[shard_idx::shard_count]
                               for n, p in per_class_paths.items()}
            self.samples = [(n, path) for n in self.class_names
                            for path in per_class_paths[n]]
        shard_note = ("" if data_shard is None else
                      " (after data_shard={} striding)".format(data_shard))
        if not self.samples:
            raise ValueError("no images found under {}{}".format(base_folder, shard_note))
        if class_balance:
            empty = [n for n, p in per_class_paths.items() if not p]
            if empty:
                raise ValueError("class_balance=True but these classes have no "
                                 "images{}: {}".format(shard_note, empty))
        self.class_cycle = itertools.cycle(
            (name, itertools.cycle(paths)) for name, paths in per_class_paths.items())
        self.index_cycle = itertools.cycle(range(len(self.samples)))
        print("Number of samples: ", len(self.samples), file=sys.stderr)

    def shuffle_indices(self):
        """Reshuffle the flat index cycle (the reference's epoch protocol);
        there is no producer thread to pause."""
        self.index_cycle = itertools.cycle(list(np.random.permutation(len(self.samples))))

    def get_batch_list(self, class_balance=True):
        """One (paths, labels) draw of batch_size samples."""
        X_batch_list, y_batch_list = [], []
        if class_balance:
            for _ in range(self.batch_size):
                c_name, path_cycle = next(self.class_cycle)
                y_batch_list.append(self.class_name_num_map[c_name])
                X_batch_list.append(next(path_cycle))
        else:
            for _ in range(self.batch_size):
                c_name, path = self.samples[next(self.index_cycle)]
                y_batch_list.append(self.class_name_num_map[c_name])
                X_batch_list.append(path)
        return X_batch_list, y_batch_list
