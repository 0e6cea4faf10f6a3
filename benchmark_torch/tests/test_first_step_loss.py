"""ResNet-50's first checked step's loss gap (``loss1_gap``) at a test's
size on the CPU: the cell's limits catch a reported loss altered by one
part in a thousand through that number, which the later steps' rounding
hides from ``loss_gap`` (``PERF.md`` §2). The sound run and the other
faults are ``tests/test_bench_resnet50_cell.py``'s."""

import time

import pytest
import torch

from benchmark_torch.harness import checks, runner

WORKLOAD = "resnet50.train.step"
SIZE = {"config": {"image_hw": [64, 64]}, "traffic": {"batch": 8, "pool_batches": 2}}
SEED = 2**31 + 101


@pytest.fixture
def one_thread():
    """ResNet-50's convolutions on OpenMP pools oversubscribed by the suite's
    workers run ten times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_altered_answer_fails_on_the_first_loss(one_thread):
    result, _ = runner.run_cell(WORKLOAD, SEED, 1.0, 0, time.perf_counter(), device="cpu",
                                overrides=SIZE, fault="altered_answer")
    limit = checks.load_limits(WORKLOAD)["loss1_gap"]
    first = result["checks"]["loss1_gap"]
    assert not result["correct"]
    assert first["limit"] == limit and first["value"] > 10 * limit, first
