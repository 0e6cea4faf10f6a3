"""Host-to-device prefetch and batch stacking (counterpart of
``dorknet_tpu/data_loading/prefetch.py``).

``device_prefetch`` keeps ``size`` batches in flight: each numpy array of a
batch is copied into pinned host memory and sent to the device with a
non-blocking copy on the current stream, so the copy of the next batch
overlaps the work on this one. ``InferenceRunner.predict_iter`` streams its
batches through it; the training steps take their batches already on the
device (``DeviceResidentDataset``) and do not.

The pinned memory is a ``PinnedRing``: ``size + 1`` slots of page-locked
host buffers, taken in turn and grown only when an array outgrows its
buffer, so a stream pins memory once rather than for every array of every
batch. After a batch's copies are queued the slot records a CUDA event, and
the slot is not written again until that event has passed: a buffer is never
overwritten while its copy is in flight.

Spans (``utils/tracing.span``, while ``torch.profiler`` records):
``prefetch.stage`` around one batch's copy into pinned memory and its queued
upload, and ``ring.wait`` around a ``PinnedRing`` wait that blocks (the
slot's event is tested only while the profiler records, so an unblocked
wait opens no range).
"""

import collections
import itertools

import numpy as np
import torch

from dorknet_tpu_torch.network.inference import resolve_device
from dorknet_tpu_torch.utils import tracing


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


class PinnedRing:
    """``slots`` slots of pinned host memory for copies to or from the card.
    ``acquire()`` hands out the next slot once the copies last queued through
    it are done; ``view(slot, key, dtype, shape)`` is a buffer of that slot
    (one per ``key``), grown when too small; ``release(slot)`` records an
    event on the current stream after the slot's copies. ``allocations``
    counts the pinned buffers allocated."""

    def __init__(self, slots):
        self.slots = int(slots)
        self._buffers = [{} for _ in range(self.slots)]
        self._events = [None] * self.slots
        self._next = 0
        self.allocations = 0

    def acquire(self):
        slot = self._next
        self._next = (slot + 1) % self.slots
        self.wait(slot)
        return slot

    def wait(self, slot):
        """Block until the copies last queued through ``slot`` are done."""
        event = self._events[slot]
        if event is not None:
            if tracing.recording() and not event.query():
                with tracing.span("ring.wait"):
                    event.synchronize()
            else:
                event.synchronize()
            self._events[slot] = None

    def view(self, slot, key, dtype, shape):
        nbytes = int(np.prod(shape)) * dtype.itemsize
        buf = self._buffers[slot].get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._buffers[slot][key] = buf
            self.allocations += 1
        return buf[:nbytes].view(dtype).view(shape)

    def release(self, slot, device):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._events[slot] = event


def device_prefetch(iterator, size=2, device="cuda", ring=None):
    """Wrap an iterator of batches (tuples, lists or dicts of numpy arrays);
    yield the same structures with every array a tensor on ``device`` (the
    card unless the caller asks for the CPU), ``size`` batches ahead. float64
    arrays become float32; other elements pass through. On the card the
    arrays go through ``ring`` (a ``PinnedRing``; one of ``size + 1`` slots
    by default); on the CPU the tensors share the arrays' memory."""
    device = resolve_device(device, "device_prefetch")
    pinned = device.type == "cuda"
    if pinned and ring is None:
        ring = PinnedRing(size + 1)

    def put(x, slot, keys):
        if isinstance(x, np.ndarray) and x.dtype == np.float64:
            x = x.astype(np.float32)
        if not isinstance(x, (np.ndarray, np.generic)):
            return x  # non-array elements (e.g. label lists) pass through
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not pinned:
            return t.to(device)
        host = ring.view(slot, next(keys), t.dtype, t.shape)
        host.copy_(t)
        return host.to(device, non_blocking=True)

    def stage(batch):
        with tracing.span("prefetch.stage"):
            if not pinned:
                return _map(lambda x: put(x, None, None), batch)
            slot = ring.acquire()
            keys = itertools.count()
            out = _map(lambda x: put(x, slot, keys), batch)
            ring.release(slot, device)
            return out

    buf = collections.deque()
    for batch in iterator:
        buf.append(stage(batch))
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
