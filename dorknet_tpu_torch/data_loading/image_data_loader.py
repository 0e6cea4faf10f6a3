"""The threaded image loader over a packed directory (counterpart of
``dorknet_tpu/data_loading/image_data_loader.py``).

* Classes come from the pack (sorted names, labels in that order), and the
  sampling protocol is the JAX package's: class-balanced round-robin over
  per-class path cycles, or a flat index cycle over all samples that
  ``shuffle_indices`` reshuffles with ``np.random.permutation``;
  ``data_shard`` keeps a stride of each class's sorted list.
* A background producer thread fills a bounded queue (5 batches) with
  ``(X, y_list, one_hot)``: X the (B, 3, H, W) float32 crops of
  ``preprocess_canvas`` (cropped on a ThreadPool of ``num_workers``), or,
  with ``emit_hwc_uint8``, the (B, ph, pw, 3) uint8 canvases themselves for
  the augmentation on the card (``Trainer.step_augmented``).
* With ``mixup_range_tuple`` each draw gives two batches, the two convex
  orderings of a batch pair (``mixup_pair``).
* ``shuffle_indices`` pauses the producer, drains the queued batches of the
  old order, reshuffles and restarts it; ``stop_thread`` ends it.

Under the same ``np.random.seed`` both packages yield the same batches. The
loader draws from numpy's global RNG on its producer thread (and random
crops on its pool's threads, in a fixed order only with ``num_workers=1``),
as the JAX package's does, so a reproducible run seeds before constructing
it and leaves the global RNG alone while the thread runs. Decoding a JPEG tree
(cv2 or the native loader) is not ported (ROADMAP A5): a directory that is
not packed raises ``NotImplementedError``.
"""

import itertools
import queue
import sys
import threading
import traceback
from multiprocessing.pool import ThreadPool

import numpy as np

from dorknet_tpu_torch.data_loading.image_preprocessor import (  # noqa: F401 (re-exported)
    default_precrop, preprocess_canvas)
from dorknet_tpu_torch.data_loading.packed_dataset import PackedDataset, is_packed_dir

_NOT_PORTED = ("loading a JPEG tree needs a decoder (cv2 or the native loader), which "
               "the port does not have yet (ROADMAP A5); pack the dataset first")


def mixup_pair(X_a, y_a, X_b, y_b, lam):
    """The reference's host mixup: both convex orderings of a batch pair,
    ``[(lam*Xb + (1-lam)*Xa, the matching soft labels), (the mirror)]``."""
    blend = lambda u, v: (lam * u + (1 - lam) * v).astype(np.float32)  # noqa: E731
    return [(blend(X_b, X_a), blend(y_b, y_a)),
            (blend(X_a, X_b), blend(y_a, y_b))]


class ImageDataLoader:
    def __init__(self, base_folder, batch_size, preprocessor,
                 classes_from_dir_structure=True, num_workers=1,
                 class_balance=True, mixup_range_tuple=None,
                 start_thread=True, emit_hwc_uint8=False, data_shard=None):
        """A loader over the packed directory ``base_folder``, whose canvases
        must have ``preprocessor.precrop_size``. emit_hwc_uint8: emit the
        uint8 canvases (the mode of the augmentation on the card; mixup is
        then left to the card and ``mixup_range_tuple`` ignored).
        data_shard=(index, count) keeps every count-th path of each class's
        sorted list, from index, so the shards are disjoint and together
        cover the dataset; labels come from the full class list.
        start_thread=False builds the sampler alone (``get_batch_list``).
        The JAX package's decoding options (``use_native_loader``,
        ``fast_jpeg_scale``) have no use over a packed directory and are
        not taken."""
        if not is_packed_dir(base_folder):
            raise NotImplementedError(
                "ImageDataLoader over {}, which is not a packed directory: {}".format(
                    base_folder, _NOT_PORTED))
        if not classes_from_dir_structure:
            raise ValueError(
                "classes_from_dir_structure=False is not supported: the loader's "
                "sampling state comes from the class layout of the dataset")
        if start_thread and not emit_hwc_uint8 and preprocessor.crop_mode not in (
                "random", "center"):
            raise NotImplementedError(
                "ImageDataLoader without a crop mode resizes each canvas, which needs "
                "cv2, which the port does not use yet (ROADMAP A5)")
        self.keep_loading = True
        self.preprocessor = preprocessor
        self.emit_hwc_uint8 = emit_hwc_uint8
        self.mixup_range_tuple = None if emit_hwc_uint8 else mixup_range_tuple
        self.base_folder = base_folder
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.batch_queue = queue.Queue(maxsize=5)
        self.class_balance = class_balance
        # the pause handshake's state, guarded by _cond
        self._cond = threading.Condition()
        self._pause_requests = 0
        self._producer_paused = False
        self._lock = threading.Lock()  # guards the sampling cycles

        self.packed = PackedDataset(base_folder)
        self._packed_row = {p: i for i, p in enumerate(self.packed.paths)}
        pw, ph = preprocessor.precrop_size
        if tuple(self.packed.precrop) != (ph, pw):
            raise ValueError(
                "packed dataset {} holds {}-pixel canvases but the preprocessor "
                "wants precrop {}; repack it".format(base_folder, self.packed.precrop,
                                                     (ph, pw)))
        self.class_name_num_map = {name: label for label, name in
                                   enumerate(self.packed.class_names)}
        self.class_names = list(self.class_name_num_map)
        per_class_paths = {name: [self.packed.paths[r] for r in rows]
                           for name, rows in self.packed.per_class_rows.items()}
        if data_shard is not None:
            shard_idx, shard_count = data_shard
            if not (isinstance(shard_idx, int) and isinstance(shard_count, int)
                    and shard_count >= 1 and 0 <= shard_idx < shard_count):
                raise ValueError(
                    "data_shard must be (process_index, process_count) with "
                    "0 <= index < count, got {!r}".format(data_shard))
            per_class_paths = {n: p[shard_idx::shard_count]
                               for n, p in per_class_paths.items()}
        self.samples = [(n, path) for n in self.class_names for path in per_class_paths[n]]
        # fail here, not in the producer, whose cycles would raise forever
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

        self.queue_thread = threading.Thread(target=self.load_batch,
                                             args=(self.class_balance,), daemon=True)
        if start_thread:
            self.queue_thread.start()

    # ------------------------------------------------------------------ #
    def stop_thread(self):
        """End the producer: wake it if paused, drain the queue so a put()
        returns, and join it (10 s at most)."""
        self.keep_loading = False
        with self._cond:
            self._cond.notify_all()
        self._drain()
        if self.queue_thread.is_alive():
            self.queue_thread.join(timeout=10)

    def _drain(self):
        try:
            while True:
                self.batch_queue.get_nowait()
        except queue.Empty:
            pass

    def shuffle_indices(self):
        """Pause the producer, drop the queued batches of the old order,
        reshuffle the flat index cycle and restart it."""
        with self._cond:
            self._pause_requests += 1
            self._cond.notify_all()
        try:
            # take batches off the queue (a producer blocked in put() then
            # sees the request) until it acknowledges the pause
            while True:
                with self._cond:
                    if self._producer_paused or not self.queue_thread.is_alive():
                        break
                try:
                    self.batch_queue.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._drain()
            with self._lock:
                self.index_cycle = itertools.cycle(
                    list(np.random.permutation(len(self.samples))))
        finally:
            with self._cond:
                self._pause_requests -= 1
                self._cond.notify_all()

    # ------------------------------------------------------------------ #
    def get_batch_list(self, class_balance=True):
        """One (paths, labels) draw of batch_size samples."""
        X_batch_list, y_batch_list = [], []
        with self._lock:
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

    def _decode_batch(self, pool, X_batch_list):
        """The rows of ``X_batch_list``: the canvases, or their crops."""
        canvases = self.packed.gather([self._packed_row[p] for p in X_batch_list])
        if self.emit_hwc_uint8:
            return canvases
        pp = self.preprocessor

        def prep(im):
            return preprocess_canvas(im, pp.image_size, pp.crop_mode)

        return np.stack(pool.map(prep, canvases), axis=0)

    def load_batch(self, class_balance):
        """The producer thread's loop."""
        eye = np.eye(len(self.class_names), dtype=np.float32)
        with ThreadPool(self.num_workers) as pool:
            while self.keep_loading:
                with self._cond:
                    if self._pause_requests:
                        self._producer_paused = True
                        self._cond.notify_all()
                        while self._pause_requests and self.keep_loading:
                            self._cond.wait(timeout=0.25)
                        self._producer_paused = False
                        continue
                try:
                    X_batch_list, y_batch_list = self.get_batch_list(class_balance)
                    X_batch = self._decode_batch(pool, X_batch_list)
                    one_hot_y = eye[np.asarray(y_batch_list)]
                    if self.mixup_range_tuple is not None:
                        # a partner batch, and both convex orderings
                        X_list_m, y_list_m = self.get_batch_list(class_balance)
                        X_batch_m = self._decode_batch(pool, X_list_m)
                        mixed = mixup_pair(X_batch, one_hot_y, X_batch_m,
                                           eye[np.asarray(y_list_m)],
                                           np.random.uniform(*self.mixup_range_tuple))
                        for labels, (X_mixed, y_mixed) in zip((y_batch_list, y_list_m), mixed):
                            self._put((X_mixed, labels, y_mixed))
                    else:
                        self._put((X_batch, y_batch_list, one_hot_y))
                except Exception:  # noqa: BLE001: a dead producer would hang
                    # every consumer on a silent queue; report and go on
                    print("ImageDataLoader producer: batch failed, continuing:\n"
                          + traceback.format_exc(), file=sys.stderr)

    def _put(self, item):
        while self.keep_loading:
            try:
                self.batch_queue.put(item, timeout=0.25)
                return
            except queue.Full:
                if self._pause_requests:
                    return  # a batch of the old order; shuffle drains anyway

    def pull_batch(self, num_steps):
        """Yield ``num_steps`` batches from the queue."""
        for _ in range(num_steps):
            yield self.batch_queue.get()
