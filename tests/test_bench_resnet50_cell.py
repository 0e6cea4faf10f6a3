"""The benchmark's ``resnet50.train.step`` cell run end to end on the CPU at a
test's size, through the program's plain paths, with the cell's own limits
(``benchmark_torch/limits/resnet50.train.step.json``): a sound run is
correct and reports the cell's metrics, and the bf16 control and the planted
faults the limits can see are not correct.

The size keeps every width, the stage table, the recipe (SGD with momentum
0.9 at lr 0.1) and the traffic's shape (three checked steps, three warm-up
steps, a pool of batches cycled) at 64 px, batch 8 and a pool of 2.

Over the three checked steps rounding grows: sound runs read a loss gap of
up to about 1e-3, so the cell's loss limit lies above the 1e-3 by which the
``altered_answer`` fault alters the reported loss, and that fault is not
among those its limits see. A check of the first step's loss alone, which
reads about 1e-7 in sound runs, would see it (``PERF.md`` §7).
"""

import math
import time

import pytest
import torch

from benchmark_torch.harness import runner
from benchmark_torch.harness.cell import load

WORKLOAD = "resnet50.train.step"
SIZE = {"config": {"image_hw": [64, 64]}, "traffic": {"batch": 8, "pool_batches": 2}}
SEED = 2**31 + 101


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    side by side, and ResNet-50's convolutions on OpenMP pools
    oversubscribed that way run ten times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(trace=0, **kw):
    return runner.run_cell(WORKLOAD, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                           overrides=SIZE, **kw)


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run(trace):
    result, _ = _run(trace)
    cell = load(WORKLOAD)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= names
    if trace:
        assert "conv_roofline.train" in names  # read on the card only
    else:
        assert set(result["metrics"]) == names == {"train_img_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


def test_bf16_control_fails():
    result, _ = _run(control="bf16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_planted_fault_fails(fault):
    result, _ = _run(fault=fault)
    assert not result["correct"], result["checks"]
