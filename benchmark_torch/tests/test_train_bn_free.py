"""A training cell whose model has no batch norm, run end to end through
``loops/train.run`` on the CPU: a small network of the port's layers (a
biased conv, ReLU, a biased pointwise conv, ReLU, global average pooling
and a dense classifier) under SGD with momentum, against a reference on
the plain executor's biased layers. Its checks have no ``stats_gap``, a
sound run is correct, and the bf16 control, a state left unchanged, half
of the batch left out and an altered loss are not. Also: ``worst_leaf``
with no leaves says so."""

import sys
import time

import pytest
import torch

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import checks, program
from benchmark_torch.harness.record import Record
from benchmark_torch.loops import train
from benchmark_torch.reference.plain import relu

WIDTH, CLASSES = 16, 10
CELL = cells.Cell(
    name="bn_free.train.step", chips=1,
    config={"program": {"model": __name__ + ":bn_free_net", "kwargs": {}},
            "image_hw": [16, 16], "num_classes": CLASSES,
            "train": {"optimiser": "SGDMomentum", "learning_rate": 0.1, "momentum": 0.9},
            "precision": {"compute_dtype": "float32", "tf32": False}},
    traffic={"loop": "train", "entry": "step", "batch": 16, "pool_batches": 3,
             "read_preds": False, "check_steps": 3, "warm_steps": 1, "trace_steps": 2})
# Set from CPU readings (seeds 1-12 and 2**31 + 7, two threads), largest of
# the sound runs / least of the bf16 control's three: loss1_gap 1.05e-7 /
# 2.01e-5, loss_gap 3.11e-7 / 8.40e-5, grad_gap 2.70e-5 / 1.68e-3,
# change_gap 4.28e-7 / 1.45e-3. A state left unchanged reads grad_gap and
# change_gap 1, half of the batch loss1_gap 9.3e-3 or more, and an altered
# loss 1.0e-3 on both loss gaps.
LIMITS = {"loss1_gap": 3e-6, "loss_gap": 5e-6, "grad_gap": 3e-4, "change_gap": 3e-5}


def forward(ex, x, cfg):
    """The reference of ``bn_free_net``."""
    h = relu(ex.conv("conv1", x, WIDTH, 3, 2, 1, bias=True))
    h = relu(ex.pw("pw1", h, 2 * WIDTH, bias=True))
    return ex.dense("classifier", ex.gap(h), cfg["num_classes"])


def bn_free_net(name):
    """The program's network: the same layers, l2 1e-4 on every weight as
    the reference's executor applies it."""
    from dorknet_tpu_torch.layers import (ConvLayer, DenseLayer, GlobalAveragePoolingLayer,
                                          PointwiseConvLayer, ReLu, SoftmaxWithCrossEntropy)
    from dorknet_tpu_torch.network import FeedForwardNetwork
    from dorknet_tpu_torch.regularisers.l2 import l2

    net = FeedForwardNetwork(name)
    net.add_layer(ConvLayer("conv1", filter_block_shape=(WIDTH, 3, 3, 3), stride=2, padding=1,
                            weight_regulariser=l2(1e-4)))
    net.add_layer(ReLu("relu1"))
    net.add_layer(PointwiseConvLayer("pw1", filter_block_shape=(2 * WIDTH, WIDTH),
                                     weight_regulariser=l2(1e-4)))
    net.add_layer(ReLu("relu2"))
    net.add_layer(GlobalAveragePoolingLayer("gap"))
    net.add_layer(DenseLayer("classifier", incoming_chans=2 * WIDTH, output_dim=CLASSES,
                             weight_regulariser=l2(1e-4)))
    net.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))
    return net


def _run(monkeypatch, seed, fault=None, control=None):
    monkeypatch.setattr(cells, "reference", lambda cell: sys.modules[__name__])
    program.set_precision(CELL.config["precision"], control)
    rec = Record(cell=CELL, seed=seed, seconds=0.1, trace=False, device=torch.device("cpu"),
                 t0=time.perf_counter(), control=control, fault=fault)
    train.run(rec)
    ok, _, _ = checks.verdict(rec.checks, LIMITS)
    return ok and rec.failed == 0, rec


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_sound_run_has_no_stats_gap(monkeypatch, seed):
    ok, rec = _run(monkeypatch, seed)
    assert ok, rec.checks
    assert set(rec.checks) == set(LIMITS)
    assert not any(l["op"] == "bn" for l in rec.layers)
    assert [l["op"] for l in rec.layers] == ["conv", "pw", "dense"]
    assert rec.attempted > 0 and rec.e2e["train_img_per_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_planted_fault_fails(monkeypatch, fault):
    ok, rec = _run(monkeypatch, 2**31 + 7, fault)
    assert not ok, rec.checks


def test_bf16_control_fails(monkeypatch):
    ok, rec = _run(monkeypatch, 2**31 + 7, control="bf16")
    assert not ok, rec.checks


def test_worst_leaf_with_no_leaves():
    with pytest.raises(ValueError, match="no leaves"):
        checks.worst_leaf({}, {})
