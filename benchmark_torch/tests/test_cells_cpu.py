"""Every cell's mix run end to end on the CPU at a test's size, through the
program's plain paths, with the cell's own limits: a sound run is correct,
and the bf16 control and each planted fault are not.

The sizes keep every width and the traffic's shape. The serving cells keep
their image sizes and shrink the batch, the pool and the rate; the training
cells shrink the images, the batch and the data, at sizes where fp32 runs
of the program and the reference agree as closely as at the cells' own
sizes on the chip, whose runs set the limits (``PERF.md``). Each run takes
a few seconds."""

import math
import time

import pytest

from benchmark_torch.harness import runner
from benchmark_torch.harness.cell import load

SIZES = {
    "resnet18dw.train.aug": {"config": {"image_hw": [65, 65], "precrop_hw": [81, 81],
                                        "train_set_size": 64},
                             "traffic": {"rows_per_step": 16}},
    "mnv3l.train.step": {"config": {"image_hw": [64, 64]},
                         "traffic": {"batch": 32, "pool_batches": 4}},
    "mnv3l.serve.bulk": {"traffic": {"batch": 2, "pool_batches": 2}},
}
TRAINING = ("resnet18dw.train.aug", "mnv3l.train.step")
FAULTS = [(w, f) for w in TRAINING for f in ("unchanged_state", "half_batch", "altered_answer")] \
    + [(w, "altered_answer") for w in SIZES if w not in TRAINING]
SEED = 2**31 + 101


def _run(workload, trace=0, **kw):
    return runner.run_cell(workload, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                           overrides=SIZES[workload], **kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_sound_run(workload, trace):
    result, _ = _run(workload, trace)
    cell = load(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_bf16_control_fails(workload):
    result, _ = _run(workload, control="bf16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_fails(workload, fault):
    result, _ = _run(workload, fault=fault)
    assert not result["correct"], result["checks"]
