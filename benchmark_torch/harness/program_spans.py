"""Readings of the program's own spans in a profiled slice.

The port opens ``torch.profiler`` ranges named ``dorknet.<span>`` at its
layer boundaries (``dorknet_tpu_torch/utils/tracing.py``) while a profiler
records. They are host operations on the clock of the profiler's device
records, so they need no offset. These functions take what
``trace.profile_slice`` holds: the profiler's records, the card's idle gaps
and the benchmark's spans on the profiler's clock, all in ns. They give:

- ``replay_extents``: the device extent of each ``dorknet.trainer.replay``,
  the first to the last device operation its graph launch ran, found by
  the correlation id of the graph launch inside the range (the port's
  ranges are host operations, which the profiler does not copy onto the
  card's timeline);
- ``label_gaps``: the card's idle seconds by label. Idle time inside a
  replay's extent is ``dorknet.trainer.replay:device``. A gap is cut at
  every start and end of a span inside it, and each piece goes to the
  innermost span open over it, program or benchmark. So the gap that opens
  in one step's loss read and runs through the next step's host work is
  charged to that work, where ``trace.summarise`` charges all of it to the
  span open at the gap's start;
- ``readings``: ``prelaunch_ms`` (mean over the slice's replays of the
  start of ``trainer.replay`` less the start of its ``trainer.step``),
  ``graph_gap_share`` (idle seconds inside the replays' extents over the
  slice's seconds, in percent), ``stage_ms`` and ``launch_ms`` (the mean
  ``prefetch.stage`` and ``runner.forward``), each span's count and mean
  ms, and the labelled idle. Each reading is None where the program opened
  none of its ranges.

``trace.profile_slice`` does not call them yet: that is an edit to
``harness/trace.py`` (PERF.md, Open questions).
"""

import bisect

import torch

from benchmark_torch.harness import trace

PREFIX = "dorknet."
REPLAY = PREFIX + "trainer.replay"
REPLAY_DEVICE = REPLAY + ":device"


def program_ranges(events):
    """[(start, end, name)] of the program's host ranges, by start."""
    return sorted((*trace._interval(e), e.name()) for e in events
                  if e.device_type() == torch.autograd.DeviceType.CPU
                  and e.name().startswith(PREFIX))


def replay_extents(events, ranges):
    """[(start, end)] of each replay's device work, by start: the device
    operations that carry the correlation id of a graph launch made inside
    a ``trainer.replay`` range of ``ranges``."""
    replays = [(s, f) for s, f, name in ranges if name == REPLAY]
    starts = [s for s, _ in replays]
    launches = set()
    for e in events:
        if "GraphLaunch" in e.name():
            s, _ = trace._interval(e)
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < replays[i][1]:
                launches.add(e.correlation_id())
    by_launch = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and e.correlation_id() in launches:
            s, f = trace._interval(e)
            lo, hi = by_launch.get(e.correlation_id(), (s, f))
            by_launch[e.correlation_id()] = (min(lo, s), max(hi, f))
    return sorted(by_launch.values())


class _Spans:
    """Named intervals (start, end, name): the innermost open at an instant
    is the latest-started one that has not ended (of two that start
    together, the one that ends first)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda r: (r[0], -r[1]))
        self.starts = [s for s, _, _ in self.spans]

    def innermost(self, t):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[i][1] > t:
                return self.spans[i][2]
        return "none"

    def cuts(self, a, b):
        """Every start or end of a span strictly inside (a, b)."""
        out = set()
        for s, f, _ in self.spans[:bisect.bisect_left(self.starts, b)]:
            out.update(x for x in (s, f) if a < x < b)
        return out


def label_gaps(gaps, extents, spans):
    """{label: idle seconds} of the idle intervals ``gaps``: a piece inside
    a replay's extent is ``REPLAY_DEVICE``, any other goes to the innermost
    of ``spans`` (a ``_Spans``) open over it."""
    ext = _Spans([(s, f, REPLAY_DEVICE) for s, f in extents])
    idle = {}
    for g0, g1 in gaps:
        cuts = sorted({g0, g1} | spans.cuts(g0, g1) | ext.cuts(g0, g1))
        for a, b in zip(cuts, cuts[1:]):
            label = ext.innermost(a)
            if label == "none":
                label = spans.innermost(a)
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return idle


def _mean_ms(durations_ns):
    return sum(durations_ns) / len(durations_ns) / 1e6 if durations_ns else None


def readings(events, gaps, notes, t0, t1):
    """The program's readings of one profiled slice over [t0, t1]:
    ``events`` the profiler's records, ``gaps`` the card's idle intervals,
    ``notes`` the benchmark's spans (start, end, name)."""
    ranges = [r for r in program_ranges(events) if t0 <= r[0] and r[1] <= t1]
    extents = [(max(s, t0), min(f, t1)) for s, f in replay_extents(events, ranges)
               if f > t0 and s < t1]
    by_name = {}
    for s, f, name in ranges:
        by_name.setdefault(name[len(PREFIX):], []).append(f - s)
    steps = [(s, f) for s, f, name in ranges if name == PREFIX + "trainer.step"]
    prelaunch = []
    for s, f, name in ranges:
        if name == REPLAY:
            outer = [a for a, b in steps if a <= s and f <= b]
            if outer:
                prelaunch.append(s - max(outer))
    idle = label_gaps(gaps, extents, _Spans(ranges + list(notes)))
    return {
        "counts": {k: len(v) for k, v in sorted(by_name.items())},
        "span_ms": {k: _mean_ms(v) for k, v in sorted(by_name.items())},
        "prelaunch_ms": _mean_ms(prelaunch), "prelaunch_n": len(prelaunch),
        "graph_gap_share": (100.0 * idle.get(REPLAY_DEVICE, 0.0) / ((t1 - t0) / 1e9)
                            if extents else None),
        "replay_extents": len(extents),
        "extent_ms": _mean_ms([f - s for s, f in extents]),
        "stage_ms": _mean_ms(by_name.get("prefetch.stage", [])),
        "launch_ms": _mean_ms(by_name.get("runner.forward", [])),
        "idle": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
    }
