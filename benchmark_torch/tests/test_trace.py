"""The profiled slice's arithmetic: busy time as the union of device
intervals, shares by class, idle gaps by the host span open at their
start; the bulk cell's busy rate read from it."""

from types import SimpleNamespace

import pytest

from benchmark_torch.harness import trace
from benchmark_torch.harness.cell import reader


def test_busy_union_and_idle_gaps():
    ops = [(10, 30, "void depthwise3x3_fwd_vec_kernel"), (20, 42, "Memcpy HtoD"),
           (60, 70, "elementwise_kernel add"), (65, 68, "elementwise_kernel mul")]
    notes = [(0, 50, "step_call"), (45, 100, "read"), (55, 58, "feed")]
    s = trace.summarise(ops, notes, 0, 100)
    assert s.busy_s == pytest.approx(42e-9)          # [10, 42] and [60, 70]
    assert s.window_s == pytest.approx(100e-9)
    assert s.idle_share() == pytest.approx(58.0)
    # the gaps [0, 10] and [42, 60] start inside step_call, [70, 100] inside read
    assert s.idle_by_span == pytest.approx({"step_call": 28e-9, "read": 30e-9})
    assert s.class_share(trace.ELEMENTWISE) == pytest.approx(100 * 13 / 55)
    top = s.breakdown()["device_ops"]
    assert top[0][0] == "Memcpy HtoD" and top[0][1] == pytest.approx(22e-9)


def test_busy_rate_reads_the_slice_images_over_busy_seconds():
    read = reader("busy_img_per_s.bulk")
    s = trace.summarise([(0, 500_000_000, "gemm"), (600_000_000, 700_000_000, "add")], [],
                        0, 1_000_000_000)
    assert read(SimpleNamespace(slice=s, counters={"slice_images": 1536})) == \
        pytest.approx(1536 / 0.6)
    assert read(SimpleNamespace(slice=None, counters={"slice_images": 1536})) is None
    assert read(SimpleNamespace(slice=s, counters={})) is None
