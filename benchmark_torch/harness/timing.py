"""Host spans, and device timing of kernel calls."""

import contextlib
import math
import threading
import time

import torch


class Spans:
    """Host spans (name, start, end) in ``time.perf_counter`` seconds, kept
    in memory. Safe to use from several threads."""

    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))

    def durations(self, name, start=-math.inf, end=math.inf):
        """Seconds of every ``name`` span that began in [start, end)."""
        with self._lock:
            return [t1 - t0 for n, t0, t1 in self.records if n == name and start <= t0 < end]


def mean_ms(durations):
    return 1e3 * sum(durations) / len(durations) if durations else None


def device_ms(calls, repeats=5, inner=None):
    """Device ms of one pass over ``calls`` (thunks), with the host's gaps
    between launches taken out: a spin kernel holds the card while the host
    queues a pass behind it, so the pass runs back to back between two CUDA
    events; the mean of ``repeats`` passes after one warm-up pass. A short
    list is repeated within a pass up to 20 calls (``inner`` sets it). If the
    spin ended before the host had queued the pass, it spins longer and
    measures again. (A copy of the port's on-chip smoke test's
    ``device_ms``.)"""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    inner = inner or max(1, 20 // len(calls))
    total, spin = 0.0, 20_000_000  # cycles: about 10 ms
    for _ in range(repeats):
        for _ in range(4):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(inner):
                for fn in calls:
                    fn()
            end.record()
            queued_ahead = not start.query()  # the spin still held the card
            torch.cuda.synchronize()
            if queued_ahead:
                break
            spin *= 4
        else:
            raise RuntimeError("the host could not queue {} calls ahead of the card".format(
                len(calls)))
        total += start.elapsed_time(end)
    return total / repeats / inner
