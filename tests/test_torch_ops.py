"""The port's functional ops against their ``dorknet_tpu.ops`` counterparts,
on the same numpy inputs (fp32: rtol/atol 1e-5, two fp32 implementations
that sum in different orders), plus the compute-dtype policy."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.ops as jops  # noqa: E402
from dorknet_tpu import config as jconfig  # noqa: E402

import dorknet_tpu_torch.ops as tops  # noqa: E402
from dorknet_tpu_torch import config as tconfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("fh,stride,padding,with_bias", [
    (5, 2, 1, False),   # the flagship's stem
    (3, 1, 1, True),
])
def test_conv2d(fh, stride, padding, with_bias):
    rng = np.random.RandomState(fh)
    x = rng.randn(2, 17, 17, 3).astype(np.float32)
    w = rng.randn(6, 3, fh, fh).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if with_bias else None
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                       None if b is None else jnp.asarray(b), stride, padding)
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b), stride, padding)
    assert got.is_contiguous()
    _close(got, want)


@pytest.mark.parametrize("stride,H", [(1, 8), (2, 9), (2, 8)])
def test_pointwise_conv2d(stride, H):
    """Subsample first: odd H gives ceil(H/s) rows."""
    rng = np.random.RandomState(stride * 10 + H)
    x = rng.randn(2, H, H, 16).astype(np.float32)
    w = rng.randn(24, 16).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = jops.pointwise_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride)
    got = tops.pointwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), stride)
    assert got.shape[1] == -(-H // stride)
    _close(got, want)


def test_dense():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 32).astype(np.float32)
    w = rng.randn(32, 10).astype(np.float32)
    b = rng.randn(10).astype(np.float32)
    _close(tops.dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jops.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("ndim", [4, 2])
def test_batch_norm_inference(ndim):
    rng = np.random.RandomState(ndim)
    shape = (2, 5, 5, 8) if ndim == 4 else (4, 8)
    x = rng.randn(*shape).astype(np.float32)
    gamma, beta, mean = (rng.randn(8).astype(np.float32) for _ in range(3))
    std = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    args = (gamma, beta, mean, std)
    want = jops.batch_norm_inference(jnp.asarray(x), *map(jnp.asarray, args))
    got = tops.batch_norm_inference(torch.from_numpy(x), *map(torch.from_numpy, args))
    _close(got, want)


def test_global_avg_pool():
    x = np.random.RandomState(5).randn(3, 7, 7, 16).astype(np.float32)
    _close(tops.global_avg_pool(torch.from_numpy(x)), jops.global_avg_pool(jnp.asarray(x)))


def test_softmax_probs():
    """Max-stabilised: large logits stay finite, rows sum to 1."""
    logits = (np.random.RandomState(6).randn(4, 120) * 100).astype(np.float32)
    got = tops.softmax_probs(torch.from_numpy(logits))
    _close(got, jops.softmax_probs(jnp.asarray(logits)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)


def test_compute_dtype_policy():
    """fp32 turns TF32 off for cuBLAS and cuDNN; bf16 makes convs and
    matmuls flow bf16 while BN and the softmax stay fp32 inside, agreeing
    with the JAX package's bf16 flow within bf16 rounding."""
    assert tconfig.get_compute_dtype() == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 9, 8).astype(np.float32)
    wc = (0.3 * rng.randn(8, 8, 3, 3)).astype(np.float32)
    wd = rng.randn(8, 3, 3).astype(np.float32)
    wp = (0.3 * rng.randn(8, 8)).astype(np.float32)
    b = rng.randn(8).astype(np.float32)

    def chain(ops, asarray):
        y = ops.conv2d(asarray(x), asarray(wc), asarray(b), 1, 1)
        y = ops.depthwise_conv2d(y, asarray(wd), asarray(b), 2, 1)
        return ops.pointwise_conv2d(y, asarray(wp), asarray(b), 1)

    with pytest.raises(ValueError, match="compute dtype"):
        tconfig.set_compute_dtype(torch.float16)
    tconfig.set_compute_dtype(torch.bfloat16)
    jconfig.set_compute_dtype(jnp.bfloat16)
    try:
        got = chain(tops, torch.from_numpy)
        want = chain(jops, jnp.asarray)
    finally:
        tconfig.set_compute_dtype(torch.float32)
        jconfig.set_compute_dtype(jnp.float32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the two frameworks round to bf16 at different places; one chain of
    # three layers stays within a few bf16 steps of the output's scale
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want, rtol=0, atol=0.05 * scale)
