"""Host-to-device prefetch and batch stacking (counterpart of
``dorknet_tpu/data_loading/prefetch.py``).

``device_prefetch`` keeps ``size`` batches in flight: each numpy array of a
batch is copied into pinned host memory and sent to the device with a
non-blocking copy on the current stream, so the copy of the next batch
overlaps the step on this one. The streaming ``Trainer.step_augmented``
loop feeds from it.
"""

import collections
import itertools

import numpy as np
import torch

from dorknet_tpu_torch.network.inference import resolve_device


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def device_prefetch(iterator, size=2, device="cuda"):
    """Wrap an iterator of batches (tuples, lists or dicts of numpy arrays);
    yield the same structures with every array a tensor on ``device`` (the
    card unless the caller asks for the CPU), ``size`` batches ahead. float64
    arrays become float32; other elements pass through."""
    device = resolve_device(device, "device_prefetch")
    pin = device.type == "cuda"

    def put(x):
        if isinstance(x, np.ndarray) and x.dtype == np.float64:
            x = x.astype(np.float32)
        if not isinstance(x, (np.ndarray, np.generic)):
            return x  # non-array elements (e.g. label lists) pass through
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    buf = collections.deque()
    for batch in iterator:
        buf.append(_map(put, batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def stack_batches(iterator, k):
    """Group ``k`` consecutive batches into stacked arrays for the K-step
    trainers: an iterator of (X, y, one_hot) tuples becomes one of
    (X_stack (k, ...), y_stack, one_hot_stack). Tensors stack on their
    device, numpy arrays with numpy, anything else into a list. A final
    group of fewer than k batches is dropped."""
    def stack(parts):
        if isinstance(parts[0], torch.Tensor):
            return torch.stack(parts)
        if isinstance(parts[0], (np.ndarray, np.generic)):
            return np.stack(parts)
        return list(parts)

    it = iter(iterator)
    while True:
        group = list(itertools.islice(it, k))
        if len(group) < k:
            return
        yield tuple(stack(parts) for parts in zip(*group))
