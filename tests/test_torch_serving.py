"""The port's BatchingServer over a port InferenceRunner on a small net:
coalescing, result fidelity, error isolation, backpressure and close
(modelled on tests/test_serving.py)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DenseLayer,  # noqa: E402
                                      GlobalAveragePoolingLayer, ReLu,
                                      SoftmaxWithCrossEntropy)
from dorknet_tpu_torch.network import (BatchingServer, FeedForwardNetwork,  # noqa: E402
                                       InferenceRunner, OverloadedError)
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402


def _runner(batch_size=8, classes=4):
    np.random.seed(0)
    net = FeedForwardNetwork("srv")
    net.add_layer(ConvLayer("c1", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(BatchNormLayer("bn1", incoming_chans=8))
    net.add_layer(ReLu("r1"))
    net.add_layer(GlobalAveragePoolingLayer("gap"))
    net.add_layer(DenseLayer("d1", incoming_chans=8, output_dim=classes))
    net.set_loss_layer(SoftmaxWithCrossEntropy("s"))
    seed_serving_weights(net, seed=0, calib_hw=(12, 12))
    return InferenceRunner(net, batch_size=batch_size, device="cpu")


def test_concurrent_singles_coalesce_and_match_runner():
    runner = _runner(batch_size=8)
    X = np.random.RandomState(5).randn(16, 3, 12, 12).astype(np.float32)
    direct = runner.predict_probs(X)
    results = [None] * 16
    with BatchingServer(runner, max_wait_ms=100) as srv:
        def worker(i):
            results[i] = srv.submit(X[i]).result(timeout=30)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert srv.dispatches < 16, srv.dispatches
        assert srv.rows_served == 16
    np.testing.assert_allclose(np.stack(results), direct, rtol=1e-5, atol=1e-6)
    assert results[0].shape == (4,)


def test_bad_request_fails_only_its_future():
    runner = _runner(batch_size=8)
    good = np.random.RandomState(4).randn(3, 12, 12).astype(np.float32)
    with BatchingServer(runner, max_wait_ms=50) as srv:
        bad = srv.submit(np.zeros((2, 2), np.float32))  # wrong rank
        too_big = srv.submit(np.zeros((9, 3, 12, 12), np.float32))
        ok = srv.submit(good)
        with pytest.raises(ValueError, match=r"\(C,H,W\)"):
            bad.result(timeout=30)
        with pytest.raises(ValueError, match="exceeds the runner's"):
            too_big.result(timeout=30)
        np.testing.assert_allclose(ok.result(timeout=30),
                                   runner.predict_probs(good[None])[0],
                                   rtol=1e-5, atol=1e-6)


def test_max_pending_raises_overloaded():
    runner = _runner(batch_size=4)
    x = np.random.RandomState(7).randn(3, 12, 12).astype(np.float32)
    # a long batching window parks the collector on the first request, so
    # later submits pile up in the queue
    srv = BatchingServer(runner, max_wait_ms=1500, max_pending=2)
    try:
        futs = [srv.submit(x)]
        deadline = time.time() + 10
        raised = False
        while time.time() < deadline and not raised:
            try:
                futs.append(srv.submit(x))
            except OverloadedError:
                raised = True
        assert raised, "never saw backpressure"
        for f in futs:
            assert f.result(timeout=30).shape == (4,)
    finally:
        srv.close()


def test_close_drains_pending_requests():
    runner = _runner(batch_size=8)
    X = np.random.RandomState(3).randn(5, 3, 12, 12).astype(np.float32)
    srv = BatchingServer(runner, max_wait_ms=500)
    futs = [srv.submit(X[i]) for i in range(5)]
    srv.close(timeout=30)
    np.testing.assert_allclose(np.stack([f.result(timeout=1) for f in futs]),
                               runner.predict_probs(X), rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(X[0])
    srv.close()  # idempotent
