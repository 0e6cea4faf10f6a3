"""The program's spans in a profiled slice (``harness/program_spans.py``),
on stand-in profiler records: the replays' device extents, the idle gaps'
finer labels, the readings, and every number of the ``Slice`` as
``trace.summarise`` gives it with and without the program's ranges."""

import pytest
import torch

from benchmark_torch.harness import program_spans as ps
from benchmark_torch.harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    """A stand-in for a record of ``kineto_results.events()``."""

    def __init__(self, name, start, end, device=CUDA, activity="kernel", corr=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._activity, self._corr = device, activity, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def activity_type(self):
        return self._activity

    def correlation_id(self):
        return self._corr


def _step(t, corr):
    """One training step from t: the host's step, key, stage, replay and
    outputs ranges, a row copy, the graph's three kernels with two gaps
    between them, and the output clone."""
    host = [("trainer.step", t + 1, t + 21), ("trainer.key", t + 2, t + 10),
            ("trainer.stage", t + 10, t + 14), ("trainer.replay", t + 14, t + 18),
            ("trainer.outputs", t + 18, t + 20)]
    events = [_Event("dorknet." + n, s, f, CPU, "cpu_op") for n, s, f in host]
    events += [_Event("cudaGraphLaunch", t + 15, t + 17, CPU, "cuda_runtime", corr),
               _Event("Memcpy HtoD", t + 12, t + 13, corr=corr - 1),
               _Event("void depthwise3x3_fwd_vec_kernel", t + 20, t + 30, corr=corr),
               _Event("elementwise_kernel add", t + 32, t + 40, corr=corr),
               _Event("elementwise_kernel mul", t + 43, t + 50, corr=corr),
               _Event("elementwise_kernel copy", t + 52, t + 54, corr=corr + 1)]
    return events


def _ops(events):
    """The device operations (start, end, name), as ``trace.profile_slice``
    takes them from the profiler's records."""
    return [(*trace._interval(e), e.name()) for e in events
            if e.device_type() == CUDA and trace._activity(e) not in trace.NOT_WORK]


# the card's idle intervals in [0, 112] under the two steps of _slice
GAPS = [(0, 12), (13, 20), (30, 32), (40, 43), (50, 52), (54, 68), (69, 76), (86, 88),
        (96, 99), (106, 108), (110, 112)]


def _slice():
    """Two steps, at 0 and 56, over [0, 112]; the benchmark's spans: the
    step call, then the loss read until just after the clone."""
    events = _step(0, 10) + _step(56, 20)
    notes = [(0, 22, "step_call"), (22, 56, "read"), (56, 78, "step_call"), (78, 112, "read")]
    return events, notes


def test_replay_extents_and_labelled_gaps():
    events, notes = _slice()
    assert ps.replay_extents(events, ps.program_ranges(events)) == [(20, 50), (76, 106)]
    r = ps.readings(events, GAPS, notes, 0, 112)
    # the gaps inside each graph, [30, 32] and [40, 43]
    assert r["graph_gap_share"] == pytest.approx(100 * 10 / 112)
    # the others, cut at each span's start and end: [0, 12] is step_call,
    # step, key and stage for 1, 1, 8 and 2; [54, 68] read, step_call,
    # step, key and stage for 2, 1, 1, 8 and 2; [13, 20] and [69, 76] under
    # stage, replay and outputs; [50, 52], [106, 108], [110, 112] read
    assert r["idle"] == pytest.approx({
        ps.REPLAY_DEVICE: 10e-9, "step_call": 2e-9, "dorknet.trainer.step": 2e-9,
        "dorknet.trainer.key": 16e-9, "dorknet.trainer.stage": 6e-9,
        "dorknet.trainer.replay": 8e-9, "dorknet.trainer.outputs": 4e-9, "read": 8e-9})
    assert r["prelaunch_ms"] == pytest.approx(13e-6) and r["prelaunch_n"] == 2
    assert r["counts"] == {"trainer.key": 2, "trainer.outputs": 2, "trainer.replay": 2,
                           "trainer.stage": 2, "trainer.step": 2}
    assert r["span_ms"]["trainer.key"] == pytest.approx(8e-6)
    assert r["replay_extents"] == 2 and r["extent_ms"] == pytest.approx(30e-6)
    assert r["stage_ms"] is None and r["launch_ms"] is None


def test_the_slice_numbers_are_unchanged():
    """The program's ranges change no number of the Slice, and the labelled
    idle is the Slice's idle, cut finer."""
    events, notes = _slice()
    plain = [e for e in events if not e.name().startswith("dorknet.")]
    base = trace.summarise(_ops(plain), notes, 0, 112)
    got = trace.summarise(_ops(events), notes, 0, 112)
    r = ps.readings(events, GAPS, notes, 0, 112)
    assert got.busy_s == base.busy_s and got.window_s == base.window_s
    assert got.idle_share() == base.idle_share()
    assert got.by_class == base.by_class and got.by_name == base.by_name
    assert got.idle_by_span == base.idle_by_span
    assert got.class_share(trace.ELEMENTWISE) == base.class_share(trace.ELEMENTWISE)
    assert got.breakdown() == base.breakdown()
    assert sum(b - a for a, b in GAPS) / 1e9 == pytest.approx(got.window_s - got.busy_s)
    assert sum(r["idle"].values()) == pytest.approx(sum(got.idle_by_span.values()))


def test_no_program_ranges_no_readings():
    events, notes = _slice()
    plain = [e for e in events if not e.name().startswith("dorknet.")]
    r = ps.readings(plain, GAPS, notes, 0, 112)
    assert r["counts"] == {} and r["prelaunch_ms"] is None and r["graph_gap_share"] is None
    assert r["stage_ms"] is None and r["launch_ms"] is None and r["extent_ms"] is None
    # the benchmark's own labels, cut at their boundaries: [54, 68] is read
    # for 2 and step_call for 12
    assert r["idle"] == pytest.approx({"step_call": 38e-9, "read": 18e-9})


def test_served_batch_readings():
    """Two served batches: the mean staging and forward-queuing ranges."""
    host = [("prefetch.stage", 0, 8), ("runner.forward", 8, 12), ("prefetch.stage", 30, 40),
            ("runner.forward", 40, 46), ("runner.answer", 46, 60)]
    events = [_Event("dorknet." + n, s, f, CPU, "cpu_op") for n, s, f in host]
    events.append(_Event("Memcpy HtoD (Pinned -> Device)", 5, 20))
    r = ps.readings(events, [(0, 5), (20, 60)], [(0, 60, "answer")], 0, 60)
    assert r["stage_ms"] == pytest.approx(9e-6) and r["launch_ms"] == pytest.approx(5e-6)
    assert r["prelaunch_ms"] is None and r["graph_gap_share"] is None
    # idle [0, 5] under the first staging; [20, 60] under the answer, the
    # second staging, its forward and the program's answer in turn
    assert r["idle"] == pytest.approx({
        "dorknet.prefetch.stage": 15e-9, "answer": 10e-9, "dorknet.runner.forward": 6e-9,
        "dorknet.runner.answer": 14e-9})
