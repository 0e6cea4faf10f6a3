"""The port's ``utils/metrics.py`` and ``utils/experiment.py`` on the CPU:
the twins of the JAX package's tests of them (``tests/test_utils.py``), and
files that one package writes and the other reads."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.utils.experiment import Experiment as JaxExperiment  # noqa: E402
from dorknet_tpu.utils.metrics import read_metrics as jax_read_metrics  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils.experiment import Experiment, find_latest_checkpoint  # noqa: E402
from dorknet_tpu_torch.utils.metrics import MetricsLogger, read_metrics  # noqa: E402
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402


def small_net(seed):
    np.random.seed(seed)
    return narrow_net(tlayers, tl2, FeedForwardNetwork)


def test_experiment_resume_cycle(tmp_path):
    exp = Experiment("exp1", network_factory=lambda: small_net(3), base_dir=str(tmp_path))
    net, start = exp.resume_or_init()
    assert start == 1
    X, y = batches(4, 2, 8, 12, 10)
    tr = Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu")
    tr.step(X[0], y[0])
    exp.save_epoch(net, 1, 0.5)
    tr.step(X[1], y[1])
    p2 = exp.save_epoch(net, 2, 0.75)
    assert find_latest_checkpoint(exp.dir) == (p2, 2, 0.75)
    # a new process, as it were: resume picks epoch 3 with epoch 2's weights
    exp2 = Experiment("exp1", network_factory=lambda: small_net(99), base_dir=str(tmp_path))
    net2, start2 = exp2.resume_or_init()
    assert start2 == 3
    for a, b in zip(net.parameters(), net2.parameters(), strict=True):
        assert torch.equal(a, b)
    # and the JAX package resumes the same directory to the same weights
    jnet, jstart = JaxExperiment("exp1", network_factory=None,
                                 base_dir=str(tmp_path)).resume_or_init()
    assert jstart == 3
    np.testing.assert_array_equal(np.asarray(jnet.layers[0].learned_params["weights"]),
                                  net.layers[0].weights.detach().numpy())


def test_experiment_empty_factory_preserves_subclass(tmp_path):
    exp = Experiment("sub", network_factory=lambda: ResNet18("sub", num_classes=4),
                     empty_network_factory=lambda: ResNet18("", load_layers=False),
                     base_dir=str(tmp_path))
    net, _ = exp.resume_or_init()
    net.forward(np.random.randn(2, 3, 33, 33).astype(np.float32),
                np.eye(4, dtype=np.float32)[[1, 2]])
    exp.save_epoch(net, 1, 0.5)
    net2, start2 = exp.resume_or_init()
    assert isinstance(net2, ResNet18) and start2 == 2
    assert repr(net2.layers) == repr(net.layers)


def test_resume_rejects_checkpoints_without_json(tmp_path):
    d = tmp_path / "Exp"
    d.mkdir()
    (d / "epoch_20_testacc_0.5.h5").write_bytes(b"")
    exp = Experiment("Exp", network_factory=lambda: None, base_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no structure json"):
        exp.resume_or_init()


def test_metrics_logger_roundtrip(tmp_path):
    """Bound constants merge into every record, 0-dim tensors fetch to
    floats, a resume appends, and read_metrics drops a truncated line."""
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as m:
        m.bind(model="net", batch=16)
        m.log(step=0, loss=torch.tensor(2.5))
        m.log(step=1, loss=1.25, note="ok", flag=torch.tensor(True))
    with MetricsLogger(p) as m:
        m.log(step=2, loss=np.float32(0.5))
    recs = read_metrics(p)
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(r["model"] == "net" and r["batch"] == 16 for r in recs[:2])
    assert isinstance(recs[0]["loss"], float) and recs[0]["loss"] == 2.5
    assert recs[1]["flag"] is True and "ts" in recs[0]
    with open(p, "a") as f:
        f.write('{"step": 3, "lo')
    assert [r["step"] for r in read_metrics(p)] == [0, 1, 2]
    # a resume after a kill mid-write must not merge its first record into
    # the truncated line
    with MetricsLogger(p) as m:
        m.log(step=4, loss=0.25)
    assert [r["step"] for r in read_metrics(p)] == [0, 1, 2, 4]
    with MetricsLogger(p, resume=False) as m:
        m.log(step=0)
    assert [r["step"] for r in read_metrics(p)] == [0]


def test_jax_reads_the_port_metrics_file(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as m:
        m.bind(batch=60, device_resident=True)
        for step in range(3):
            m.log(epoch=1, step=step, loss=torch.tensor(4.0 - step), lr=0.06)
        m.log(epoch=1, test_acc=0.25)
    with open(p, "a") as f:
        f.write('{"epoch": 2, "st')
    assert jax_read_metrics(p) == read_metrics(p)
    assert len(read_metrics(p)) == 4
