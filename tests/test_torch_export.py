"""Serving artifacts of the port: ``InferenceRunner.export_program`` →
``load_serving_program`` / ``load_serving_artifact``, the checks of
tests/test_export.py that need neither jax serialisation nor int8, on a
narrow depthwise-separable network (the JAX file's MNISTNet has no depthwise
layer and is not ported). Each artifact's graph calls the registered op
``dorknet::depthwise3x3`` at every depthwise layer and ``dorknet::bias_act``
at every biased layer of its layer lists, and its probs are the runner's
within 1e-6 (bit-equal at the runner's own batch). Also the export
CLI, from a json+h5 pair the JAX package wrote, and the serving demo at a
small size."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch import config  # noqa: E402
from dorknet_tpu_torch.network import (FeedForwardNetwork, InferenceRunner,  # noqa: E402
                                       ServingArtifact, load_serving_artifact,
                                       load_serving_program)
from dorknet_tpu_torch.ops.cuda.depthwise import (depthwise3x3_op,  # noqa: E402
                                                  depthwise3x3_plain)
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.serving_artifact import deserialize  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402

HW = (17, 17)
DW_LAYERS = 4  # narrow_net's depthwise layers
# narrow_net's biased layers once folded: conv0 and pw0 (each with its ReLU),
# each block's dw1, pw1 (with its ReLU) and dw2, and the dense head; the
# block's skip projection adds its bias outside the layer list. Unfolded,
# each block's dw2 and the dense head.
BIASED_FOLDED, BIASED_UNFOLDED = 9, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serving_net(seed=0):
    np.random.seed(seed)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    seed_serving_weights(net, seed=seed, calib_hw=HW)
    X = np.random.RandomState(seed + 100).randn(16, 3, *HW).astype(np.float32)
    return net, X


def _runner(seed, **kw):
    net, X = _serving_net(seed)
    return InferenceRunner(net, batch_size=8, device="cpu", **kw), X


def _op_calls(blob, op=torch.ops.dorknet.depthwise3x3.default):
    return sum(n.target is op for n in deserialize(blob).graph.nodes)


def _bias_calls(blob):
    return _op_calls(blob, torch.ops.dorknet.bias_act.default)


def test_artifact_roundtrip_matches_runner(tmp_path):
    runner, X = _runner(0, fold_bn=True)
    path = str(tmp_path / "narrow.pt2")
    data = runner.export_program(HW, path=path)
    assert len(data) > 0 and _op_calls(data) == DW_LAYERS
    assert _bias_calls(data) == BIASED_FOLDED

    art = load_serving_artifact(path)
    assert isinstance(art, ServingArtifact)
    assert art.batch_size == 8 and art.input_shape == (3, *HW)
    assert not art.polymorphic_batch and art.num_classes == 10
    assert art.platforms == ("cpu",)
    # the same program and constants at the runner's batch: bit-equal
    np.testing.assert_array_equal(runner.predict_probs(X), art.predict_probs(X))
    np.testing.assert_array_equal(art.predict_probs(X),
                                  load_serving_artifact(data).predict_probs(X))
    served = load_serving_program(data)(torch.from_numpy(X[:8]))
    assert isinstance(served, torch.Tensor) and served.shape == (8, 10)
    np.testing.assert_array_equal(served.numpy(), runner.predict_probs(X[:8]))


def test_export_meta_sidecar(tmp_path):
    runner, _ = _runner(0)
    path = str(tmp_path / "m.pt2")
    data = runner.export_program(HW, path=path)
    assert _op_calls(data) == DW_LAYERS and _bias_calls(data) == BIASED_UNFOLDED
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["format"] == "torch.export"
    assert meta["input_shape"] == [8, 3, *HW]
    assert meta["input_dtype"] == "float32"
    assert meta["runner"] == "InferenceRunner"
    assert meta["output_avals"] == [{"shape": [8, 10], "dtype": "float32"}]
    assert meta["platforms"] == ["cpu"]
    assert meta["polymorphic_batch"] is False


def test_artifact_ragged_padding_matches_runner_protocol():
    """predict_probs on N not divisible by the exported batch chunks and
    pads exactly as the live runner does."""
    runner, X = _runner(1, fold_bn=True)
    art = load_serving_artifact(runner.export_program(HW))
    Xr = X[:13]  # 8 + ragged 5
    np.testing.assert_array_equal(runner.predict_probs(Xr), art.predict_probs(Xr))
    assert art.predict(Xr).shape == (13,)


def test_export_polymorphic_batch():
    """One artifact, any batch from 1 (the batch is a symbolic Dim with an
    explicit range, so sizes 1 and 7 run too): the runner's probs within
    1e-6 (another batch size sums the GEMMs in other blocks)."""
    runner, X = _runner(2, fold_bn=True)
    data = runner.export_program(HW, polymorphic_batch=True)
    assert _op_calls(data) == DW_LAYERS and _bias_calls(data) == BIASED_FOLDED
    art = load_serving_artifact(data)
    assert art.polymorphic_batch and art.batch_size is None
    for n in (1, 3, 7, 8, 11):
        p = art.predict_probs(X[:n])
        assert p.shape == (n, 10)
        np.testing.assert_allclose(p, runner.predict_probs(X[:n]), rtol=0, atol=1e-6)
    raw = load_serving_program(data)
    for n in (1, 7):
        assert raw(X[:n]).shape == (n, 10)


def test_polymorphic_artifact_chunks_to_max_batch():
    """A polymorphic artifact dispatches an eval-sized input in chunks of
    max_batch rows, unpadded."""
    runner, X = _runner(6, fold_bn=True)
    art = load_serving_artifact(runner.export_program(HW, polymorphic_batch=True),
                                max_batch=4)
    assert art.max_batch == 4
    seen = []
    inner = art._call
    art._call = lambda x: (seen.append(x.shape[0]), inner(x))[1]
    p = art.predict_probs(X[:11])
    assert seen == [4, 4, 3]
    np.testing.assert_allclose(p, runner.predict_probs(X[:11]), rtol=0, atol=1e-6)


def test_predict_probs_empty_input():
    """N=0 returns (0, num_classes) on every serving path."""
    runner, X = _runner(7, fold_bn=True)
    empty = X[:0]
    assert runner.predict_probs(empty).shape == (0, 10)
    assert runner.predict(empty).shape == (0,)
    fixed = load_serving_artifact(runner.export_program(HW))
    poly = load_serving_artifact(runner.export_program(HW, polymorphic_batch=True))
    for art in (fixed, poly):
        assert art.predict_probs(empty).shape == (0, 10)
        assert art.predict(empty).shape == (0,)


def test_export_respects_compute_dtype_policy():
    """The artifact keeps the compute dtype set at export time: setting the
    global dtype back afterwards does not change what it serves. In bf16
    flow the depthwise and biased layers still call the ops."""
    runner, X = _runner(4, fold_bn=True)
    p32 = runner.predict_probs(X)
    config.set_compute_dtype(torch.bfloat16)
    try:
        p_bf16 = runner.predict_probs(X)
        data = runner.export_program(HW)
    finally:
        config.set_compute_dtype(torch.float32)
    assert np.abs(p_bf16 - p32).max() > 1e-4  # bf16 flow did change the probs
    assert _op_calls(data) == DW_LAYERS and _bias_calls(data) == BIASED_FOLDED
    np.testing.assert_array_equal(p_bf16, load_serving_artifact(data).predict_probs(X))


def test_depthwise_op_is_registered_with_a_fake():
    """dorknet::depthwise3x3 runs the plain version on CPU tensors, and its
    fake function gives the output's shape and dtype without data."""
    g = np.random.RandomState(3)
    for stride, dtype in ((1, torch.float32), (2, torch.bfloat16)):
        x = torch.from_numpy(g.randn(2, 9, 7, 8).astype(np.float32)).to(dtype)
        w = torch.from_numpy(g.randn(8, 3, 3).astype(np.float32))
        assert torch.equal(depthwise3x3_op(x, w, stride), depthwise3x3_plain(x, w, stride))
        torch.library.opcheck(torch.ops.dorknet.depthwise3x3.default, (x, w, stride),
                              test_utils=("test_schema", "test_faketensor"))


def test_loading_imports_no_model_code(tmp_path):
    """A fresh process loads and serves an artifact with torch and the op's
    module alone: nothing of the layers, the network, the model zoo or the
    checkpoints (nor jax, h5py or dorknet_tpu) is imported."""
    runner, X = _runner(8, fold_bn=True)
    path = str(tmp_path / "a.pt2")
    runner.export_program(HW, path=path)
    np.save(str(tmp_path / "x.npy"), X)
    np.save(str(tmp_path / "want.npy"), runner.predict_probs(X))
    code = (
        "import sys, numpy as np\n"
        "from dorknet_tpu_torch.serving_artifact import load_serving_artifact\n"
        "d = sys.argv[1]\n"
        "p = load_serving_artifact(d + '/a.pt2').predict_probs(np.load(d + '/x.npy'))\n"
        "np.testing.assert_array_equal(p, np.load(d + '/want.npy'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'h5py', 'dorknet_tpu')\n"
        "       or m.startswith(('dorknet_tpu_torch.layers', 'dorknet_tpu_torch.network',\n"
        "                        'dorknet_tpu_torch.models', 'dorknet_tpu_torch.utils'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                   check=True, timeout=300)


def test_export_cli_from_jax_checkpoint(tmp_path):
    """dorknet_tpu_torch.tools.export_serving: a json+h5 checkpoint written by
    the JAX package in, an artifact out that serves a folded runner's probs
    built from the same files."""
    from dorknet_tpu_torch.tools.export_serving import main as export_main

    np.random.seed(5)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    X, y = batches(5, 2, 8, HW[0], 10)
    trainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9))
    for k in range(2):
        trainer.step(X[k], y[k])
    jpath, hpath = str(tmp_path / "net.json"), str(tmp_path / "net.h5")
    jnet.save_layer_structure_to_json(jpath)
    jnet.save_weights_to_h5(hpath)

    out = str(tmp_path / "net.pt2")
    export_main(["--json", jpath, "--h5", hpath, "--out", out, "--input", "3,17,17",
                 "--batch", "8", "--device", "cpu"])
    assert os.path.exists(out + ".meta.json")
    net = FeedForwardNetwork("ref")
    net.load_network_from_json_and_h5(jpath, hpath)
    ref = InferenceRunner(net, batch_size=8, device="cpu", fold_bn=True)
    Xe = np.concatenate([X[0], X[1][:3]])
    art = load_serving_artifact(out)
    assert _op_calls(open(out, "rb").read()) == DW_LAYERS
    np.testing.assert_allclose(art.predict_probs(Xe), ref.predict_probs(Xe), rtol=0, atol=1e-6)
    assert config.get_compute_dtype() == torch.float32

    poly = str(tmp_path / "poly.pt2")
    export_main(["--json", jpath, "--h5", hpath, "--out", poly, "--input", "3,17,17",
                 "--batch", "8", "--device", "cpu", "--polymorphic", "--no-fold-bn"])
    plain = InferenceRunner(net, batch_size=8, device="cpu")
    np.testing.assert_allclose(load_serving_artifact(poly).predict_probs(Xe[:5]),
                               plain.predict_probs(Xe[:5]), rtol=0, atol=1e-6)


def test_serving_demo_runs_on_the_cpu(capsys):
    """The demo's ladder at a small size: every rung runs, the int8 rung is
    skipped with its line, and the artifacts agree with their runner."""
    from dorknet_tpu_torch.examples.serving_demo import main

    main(steps=3, device="cpu", batch=8, size=16)
    out = capsys.readouterr().out
    for rung in ("InferenceRunner(fold_bn)", "EMA weights + fold_bn", "BatchingServer",
                 "export_program", "polymorphic artifact"):
        assert rung in out
    assert "skipped: QuantizedInferenceRunner comes with A7" in out
    assert "reloaded top-1 agreement with the runner it serialised: 1.000" in out
    assert "top-1 agreement [1.0, 1.0, 1.0]" in out
