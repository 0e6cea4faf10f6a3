"""Structured training metrics, one JSON object a line, appended (the
counterpart of ``dorknet_tpu/utils/metrics.py``).

The reference logs free text through ``logging``. ``MetricsLogger`` keeps
that console flow and adds a machine-readable sidecar: each ``log()`` call
appends one JSON line (a wall-clock timestamp and the scalars the caller
passes), so loss curves, learning rates and throughput can be read back
after a run, across restarts too, since the file is opened for appending.

- A 0-dim tensor is fetched with ``.item()`` at log time, which waits for
  the card: logging a step's loss is that step's synchronisation point.
- Each line is flushed at once: a run killed mid-way leaves valid JSONL up
  to its last completed ``log()``.
"""

import json
import os
import time

import torch

__all__ = ["MetricsLogger", "read_metrics"]


def _scalar(v):
    """A JSON-serialisable scalar: a 0-dim tensor through ``.item()`` (the
    fetch that waits for the card), numpy scalars and anything else with
    ``__float__`` as float, anything else as its repr. Bools, ints, floats,
    strings and None pass through."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        return v.item()
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class MetricsLogger:
    """Append-mode JSONL metrics writer.

        with MetricsLogger("run/metrics.jsonl") as m:
            for step in ...:
                loss, _ = trainer.step(X, y)
                m.log(step=step, epoch=e, loss=loss,
                      lr=opt.learning_rate)

    Every record carries ``ts`` (unix seconds). Extra per-run constants can be
    bound once via ``bind`` (e.g. ``m.bind(model="resnet18", batch=128)``) and
    are merged into every subsequent record."""

    def __init__(self, path, resume=True):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._bound = {}
        self._f = open(path, "a" if resume else "w")
        if resume and self._f.tell() > 0:
            # a run killed mid-write leaves a truncated line with no trailing
            # newline; appending straight onto it would merge the first
            # resumed record into an unparseable line — terminate it first
            with open(path, "rb") as chk:
                chk.seek(-1, os.SEEK_END)
                if chk.read(1) != b"\n":
                    self._f.write("\n")
                    self._f.flush()

    def bind(self, **constants):
        self._bound.update({k: _scalar(v) for k, v in constants.items()})
        return self

    def log(self, **scalars):
        rec = {"ts": time.time()}
        rec.update(self._bound)
        rec.update({k: _scalar(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_metrics(path):
    """Parse a metrics JSONL file back into a list of dicts. Unparseable
    lines (e.g. one truncated by a mid-write kill) are dropped individually,
    so records after them — a resumed run's — still load."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
