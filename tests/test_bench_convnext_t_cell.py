"""The benchmark's ``convnext_t.train.step`` cell on the CPU, through
``runner.run_cell`` and the program's ``ConvNeXt`` and ``AdamW``, with the
cell's own limits (``benchmark_torch/limits/convnext_t.train.step.json``).

At the published sizes, in the reference's ``"spec"`` mode: ConvNeXt-T's
28,589,128 parameters, 23 LayerNorm rows, 18 7x7 depthwise rows, no batch
norm, and its trained FLOPs an image.

At a test's size (every published width and depth at 64 px, batch 4, a
pool of 2, one intra-op thread): a sound run is correct and has no
``stats_gap`` among its checks, and the bf16 control and each planted
fault the limits are set to see (a state left unchanged, half of the batch
left out, an altered loss) are not correct.
"""

import math
import time

import pytest
import torch

from benchmark_torch.harness import runner
from benchmark_torch.harness.cell import load, reference
from benchmark_torch.harness.checks import load_limits
from benchmark_torch.reference.plain import layer_table
from benchmark_torch.work import counts

WORKLOAD = "convnext_t.train.step"
SIZE = {"config": {"image_hw": [64, 64]}, "traffic": {"batch": 4, "pool_batches": 2}}
SEED = 2**31 + 103


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    side by side, and convolutions on OpenMP pools oversubscribed that way
    run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(trace=0, **kw):
    return runner.run_cell(WORKLOAD, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                           overrides=SIZE, **kw)


def test_published_sizes_in_the_layer_table():
    cell = load(WORKLOAD)
    assert cell.config["reduced"] == [] and cell.traffic["batch"] == 128
    spec, layers, reg = layer_table(reference(cell).forward, cell.config, 128)
    assert sum(math.prod(shape) for _, shape, _, _ in spec) == 28_589_128
    ops = [l["op"] for l in layers]
    assert ops.count("ln") == 23 and ops.count("scale") == 18 and "bn" not in ops
    dws = [l for l in layers if l["op"] == "dw"]
    assert len(dws) == 18 and {l["k"] for l in dws} == {7}
    assert counts.dw3x3_layers(layers) == [] and counts.bn_layers(layers) == []
    assert reg == []  # AdamW decays the weights: no l2 term
    assert counts.train_flops_per_image(layers) == 26_704_286_208
    assert layers[0]["x"] == (128, 3, 224, 224) and layers[-1]["y"] == (128, 1000)


def test_limits_name_no_stats_gap():
    assert set(load_limits(WORKLOAD)) == {"loss1_gap", "loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run(trace):
    result, _ = _run(trace)
    cell = load(WORKLOAD)
    assert result["correct"], result["checks"]
    assert "stats_gap" not in result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= names
    if trace:  # read on the card only
        assert {"dw7x7_roofline.train", "layernorm_roofline.train", "mfu.train",
                "conv_roofline.train"} <= names
    else:
        assert set(result["metrics"]) == names == {"train_img_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


def test_bf16_control_fails():
    result, _ = _run(control="bf16")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_planted_fault_fails(fault):
    result, _ = _run(fault=fault)
    assert not result["correct"], result["checks"]
