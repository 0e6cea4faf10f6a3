"""Dynamic-batching serving front-end (a copy of
``dorknet_tpu/network/serving.py``, which is pure Python and numpy; the port
carries its own copy because importing anything from ``dorknet_tpu`` imports
jax).

``BatchingServer`` sits in front of an ``InferenceRunner`` and coalesces
concurrent requests into the runner's fixed batch: callers ``submit()`` one
image (or a few rows) and get a Future; a collector thread fills a batch — up
to ``max_wait_ms`` of batching delay, the standard latency/throughput knob —
and serves everyone with one device dispatch. Padding to the batch shape is
the runner's; a failing request fails only its own future.
"""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class OverloadedError(RuntimeError):
    """Raised by ``BatchingServer.submit`` when ``max_pending`` requests are
    already queued — the backpressure signal for callers to shed or retry."""


class BatchingServer:
    """Thread-safe dynamic batcher over a runner with ``predict_probs``.

    - ``submit(x)``: x is one image ``(C, H, W)`` or a few rows
      ``(n, C, H, W)`` with ``n <= runner.batch_size``. Returns a
      ``concurrent.futures.Future`` resolving to the ``(num_classes,)`` (or
      ``(n, num_classes)``) softmax scores.
    - requests are served FIFO; a request whose rows don't fit the batch
      being assembled is carried (un-reordered) into the next dispatch.
    - a failing request (bad shape) fails ITS future; the batch's other
      requests and the server keep going.
    """

    def __init__(self, runner, max_wait_ms=2.0, max_pending=None):
        """max_pending bounds the request queue (backpressure): when that many
        requests are already waiting, ``submit`` raises ``OverloadedError``
        immediately instead of growing the queue without bound — callers
        shed load or retry. None (default) = unbounded."""
        self.runner = runner
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_pending = None if max_pending is None else int(max_pending)
        self._q = queue.Queue()
        self._closed = False
        self._carry = None
        # guards the closed-check+enqueue pair in submit against racing
        # close() (a submit slipping in after close drained the queue would
        # leave its future unresolved forever)
        self._submit_lock = threading.Lock()
        # observability: device dispatches vs rows served (the batching win)
        self.dispatches = 0
        self.rows_served = 0
        self._thread = threading.Thread(target=self._collect_loop,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def submit(self, x):
        fut = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchingServer is closed")
            if (self.max_pending is not None
                    and self._q.qsize() >= self.max_pending):
                raise OverloadedError(
                    f"{self._q.qsize()} requests already pending "
                    f"(max_pending={self.max_pending}) — shed load or retry")
            self._q.put((np.asarray(x, dtype=np.float32), fut))
        return fut

    def predict_probs(self, x):
        """Synchronous convenience: submit + wait."""
        return self.submit(x).result()

    def close(self, timeout=5.0):
        """Stop the collector; pending requests are still drained first."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)  # sentinel
        self._thread.join(timeout)
        if self._thread.is_alive():
            # collector still mid-dispatch: draining now could steal the
            # sentinel and leave the thread blocked forever — let it finish
            # the in-flight batch and consume the sentinel itself (submit is
            # already refused, so nothing new can queue behind it)
            return
        # collector exited; fail anything still queued behind the sentinel
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("BatchingServer closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------ #
    def _normalise(self, x, fut):
        """-> (rows (n,C,H,W), squeeze) or None after failing the future."""
        if x.ndim == 3:
            rows, squeeze = x[None], True
        elif x.ndim == 4:
            rows, squeeze = x, False
        else:
            fut.set_exception(ValueError(
                "submit() wants (C,H,W) or (n,C,H,W), got shape "
                f"{x.shape}"))
            return None
        if rows.shape[0] > self.runner.batch_size:
            fut.set_exception(ValueError(
                f"request of {rows.shape[0]} rows exceeds the runner's "
                f"batch_size {self.runner.batch_size}; chunk it or use the "
                "runner's predict_probs directly"))
            return None
        return rows, squeeze

    def _collect_loop(self):
        B = self.runner.batch_size
        while True:
            # first item: block indefinitely (or wake on the close sentinel)
            item = self._carry if self._carry is not None else self._q.get()
            self._carry = None
            if item is None:
                return
            batch = []
            n_rows = 0
            row_shape = None  # (C,H,W) of this batch — requests must agree
            deadline = time.monotonic() + self.max_wait_s

            def admit(it):
                nonlocal n_rows, row_shape
                norm = self._normalise(it[0], it[1])
                if norm is None:
                    return True  # failed its future; slot stays open
                rows, squeeze = norm
                if it[1].cancelled():
                    return True  # caller cancelled while queued; drop it
                if row_shape is not None and rows.shape[1:] != row_shape:
                    # different (C,H,W): can't concatenate — serve it in its
                    # own next dispatch (FIFO preserved via carry)
                    self._carry = it
                    return False
                if n_rows + rows.shape[0] > B:
                    self._carry = it  # FIFO: carry to the next dispatch
                    return False
                row_shape = rows.shape[1:]
                batch.append((rows, squeeze, it[1]))
                n_rows += rows.shape[0]
                return True

            admit(item)
            while n_rows < B and self._carry is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._drain_and_serve(batch, n_rows)
                    return
                if not admit(nxt):
                    break
            self._drain_and_serve(batch, n_rows)

    @staticmethod
    def _safe_set(fut, value=None, exc=None):
        """Resolve a future, tolerating a concurrent caller-side cancel
        (a set on a cancelled future raises InvalidStateError, which must
        never kill the collector thread)."""
        try:
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:
            pass

    def _drain_and_serve(self, batch, n_rows):
        if not batch:
            return
        try:
            # concatenate inside the try: admit() groups by row shape, but
            # any failure here must fail the batch's futures, not the thread
            X = np.concatenate([rows for rows, _, _ in batch], axis=0)
            probs = self.runner.predict_probs(X)
        except Exception as e:  # failure fails THIS batch only
            for _, _, fut in batch:
                self._safe_set(fut, exc=e)
            return
        self.dispatches += 1
        self.rows_served += n_rows
        off = 0
        for rows, squeeze, fut in batch:
            n = rows.shape[0]
            out = probs[off:off + n]
            self._safe_set(fut, value=out[0] if squeeze else out)
            off += n
