"""The augmentation slice against the JAX package on the CPU: the port's
``augment_planes_fused`` (its plain version on CPU tensors) against the JAX
kernel in interpret mode and against the JAX planes path, the HSV and
rotation stages alone on float input, and ``train_pipeline`` with mixup.

The random draws are the JAX package's: ``draw_batch_params`` and the mixup
keys are evaluated in JAX, converted to numpy, and handed to the port
(directly, or by replacing the port's two draw functions).

Tolerances. uint8 outputs: no pixel more than 1 step off and at most 0.1%
of pixels off (the port rounds every multiply and add separately, XLA's
compiled programs contract some into FMAs). Float stages: 1e-4 relative
and 1e-4 absolute (the JAX package's eager ops against torch's, both
fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.config as jconfig  # noqa: E402
from dorknet_tpu.data_loading import device_augment as jaug  # noqa: E402

import dorknet_tpu_torch.config as tconfig  # noqa: E402
from dorknet_tpu_torch.data_loading import device_augment as taug  # noqa: E402
from dorknet_tpu_torch.ops.cuda.augment import augment_planes_fused  # noqa: E402

AUG_CFG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)),
               rotation_tuple=(-15.0, 15.0), horizontal_flip_prob=0.5,
               crop_mode="random")
CONFIGS = {
    "all": AUG_CFG,
    "center": dict(AUG_CFG, crop_mode="center"),
    "no_rotation": dict(AUG_CFG, rotation_tuple=None),
    "no_hsv": dict(AUG_CFG, hsv_pert_tuples=None),
    "crop_only": dict(hsv_pert_tuples=None, rotation_tuple=None,
                      horizontal_flip_prob=None, crop_mode="random"),
    "no_crop": dict(AUG_CFG, crop_mode=None),
}
SIZES = [((40, 40), (32, 32)), ((30, 30), (24, 24)), ((37, 45), (29, 33))]


@pytest.fixture
def _aug_interpret(monkeypatch):
    import dorknet_tpu.ops.pallas.augment as pa

    monkeypatch.setattr(pa, "_INTERPRET", True)
    return pa


def structured_images(seed, B, H, W):
    """uint8 BGR (B,H,W,3): a smooth pattern per channel plus noise, so that
    the lerps and the HSV sectors all matter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (127 + 60 * np.sin(yy[None, :, :, None] / 5.0 + np.arange(3))
            + 50 * np.cos(xx[None, :, :, None] / 7.0))
    return np.clip(base + rng.randint(-30, 31, (B, H, W, 3)), 0, 255).astype(np.uint8)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_uint8_close(got, want, what, max_share=1e-3):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    off = int((diff > 0).sum())
    print("{}: {} of {} pixels off, max {} steps".format(what, off, diff.size, diff.max()))
    assert diff.max() <= 1, what
    assert off <= max_share * diff.size, what


@pytest.mark.parametrize("size", SIZES, ids=["40to32", "30to24", "37x45to29x33"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_matches_jax_kernel_and_planes(name, size, _aug_interpret):
    cfg = CONFIGS[name]
    (H, W), out = size
    B = 3
    x = structured_images(H + W, B, H, W)
    params = jaug.draw_batch_params(jax.random.PRNGKey(3), B, (H, W), out, **cfg)
    planes = jnp.asarray(x.transpose(0, 3, 1, 2))
    want_planes = np.asarray(jaug.augment_batch_planes(planes, params, out, **cfg))
    want_kernel = np.asarray(_aug_interpret.augment_planes_fused(planes, params, out, **cfg))
    before = augment_planes_fused.launches
    got = augment_planes_fused(torch.from_numpy(x), to_torch(params), out, **cfg).numpy()
    assert augment_planes_fused.launches == before  # CPU tensors take the plain version
    assert_uint8_close(got, want_kernel, "{} {} vs JAX kernel".format(name, size))
    assert_uint8_close(got, want_planes, "{} {} vs JAX planes".format(name, size))


def test_fused_refuses_float_and_bad_shapes():
    x = torch.zeros((2, 30, 30, 3), dtype=torch.float32)
    p = taug.draw_batch_params(torch.Generator().manual_seed(0), 2, (30, 30), (24, 24),
                               **AUG_CFG)
    with pytest.raises(TypeError, match="uint8"):
        augment_planes_fused(x, p, (24, 24), **AUG_CFG)
    with pytest.raises(ValueError, match="does not fit"):
        augment_planes_fused(x.to(torch.uint8), p, (32, 32), **AUG_CFG)
    with pytest.raises(ValueError, match="crop_mode"):
        augment_planes_fused(x.to(torch.uint8), p, (24, 24), **dict(AUG_CFG, crop_mode="x"))
    with pytest.raises(ValueError, match=r"\(B,H,W,3\)"):
        augment_planes_fused(torch.zeros((2, 3, 30, 30), dtype=torch.uint8), p, (24, 24))


def float_planes(seed, B, H, W):
    return structured_images(seed, B, H, W).transpose(0, 3, 1, 2).astype(np.float32) + \
        np.random.RandomState(seed).rand(B, 3, H, W).astype(np.float32)


@pytest.mark.parametrize("size", [(24, 24), (29, 33)])
def test_hsv_stage_matches_jax_on_float(size):
    x = float_planes(1, 4, *size)
    scales = np.random.RandomState(2).uniform([0.9, 0.5, 0.5], [1.1, 2.0, 2.0],
                                              (4, 3)).astype(np.float32)
    want = np.asarray(jaug.hsv_batch_planes(jnp.asarray(x), jnp.asarray(scales)))
    got = taug.hsv_batch_planes(torch.from_numpy(x), torch.from_numpy(scales)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [(24, 24), (29, 33)])
def test_rotate_stage_matches_jax_on_float(size):
    x = float_planes(3, 4, *size)
    deg = np.random.RandomState(4).uniform(-15, 15, 4).astype(np.float32)
    want = np.asarray(jaug.rotate_batch_planes(jnp.asarray(x), jnp.asarray(deg),
                                               (-15.0, 15.0)))
    got = taug.rotate_batch_planes(torch.from_numpy(x), torch.from_numpy(deg),
                                   (-15.0, 15.0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def jax_pipeline_draws(key, B, precrop_hw, out_hw, cfg, mixup):
    """The draws JAX's _train_pipeline_impl makes from ``key``, as tensors."""
    k_aug, k_mix = jax.random.split(key)
    params = jaug.draw_batch_params(k_aug, B, precrop_hw, out_hw, **cfg)
    k_lam, k_perm = jax.random.split(k_mix)  # as mixup_pair splits its key
    lam = jax.random.uniform(k_lam, (), minval=mixup[0], maxval=mixup[1])
    perm = jax.random.permutation(k_perm, B)
    return to_torch(params), torch.tensor(np.asarray(lam)), torch.from_numpy(np.array(perm))


def inject_draws(monkeypatch, draws):
    """Replace the port's two draw functions by ones that hand out
    ``draws`` (a list of (params, lam, perm)) in order."""
    queue = list(draws)
    current = {}

    def draw_batch_params(generator, *args, **kwargs):
        current["d"] = queue.pop(0)
        return current["d"][0]

    def draw_mixup(generator, batch, lo, hi):
        return current["d"][1], current["d"][2]

    monkeypatch.setattr(taug, "draw_batch_params", draw_batch_params)
    monkeypatch.setattr(taug, "draw_mixup", draw_mixup)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_train_pipeline_with_mixup_matches_jax(policy, monkeypatch):
    """NHWC output, mixup (0, 0.3), under each compute-dtype policy, compared
    in fp32. fp32: within 1e-4 (the mixup's products and sums round
    separately here, XLA fuses them). bf16: within 1.0, one rounding step
    of bf16 at magnitude 128 (XLA keeps the mixup's bf16 arithmetic in fp32
    and rounds once; torch rounds after every operation)."""
    B, (H, W), out = 4, (40, 40), (32, 32)
    x = structured_images(5, B, H, W)
    oh = np.eye(5, dtype=np.float32)[np.random.RandomState(6).randint(0, 5, B)]
    key = jax.random.PRNGKey(9)
    mixup = (0.0, 0.3)
    inject_draws(monkeypatch, [jax_pipeline_draws(key, B, (H, W), out, AUG_CFG, mixup)])
    jdtype, tdtype = (jnp.float32, torch.float32) if policy == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jconfig.set_compute_dtype(jdtype)
    tconfig.set_compute_dtype(tdtype)
    try:
        want_x, want_y = jaug.train_pipeline(key, jnp.asarray(x), jnp.asarray(oh), out,
                                             mixup=mixup, output_layout="NHWC", **AUG_CFG)
        got_x, got_y = taug.train_pipeline(torch.Generator(), torch.from_numpy(x),
                                           torch.from_numpy(oh), out, mixup=mixup,
                                           output_layout="NHWC", **AUG_CFG)
    finally:
        jconfig.set_compute_dtype(jnp.float32)
        tconfig.set_compute_dtype(torch.float32)
    assert got_x.dtype == tdtype and tuple(got_x.shape) == (2 * B, *out, 3)
    assert got_x.is_contiguous()
    tol = 1e-4 if policy == "float32" else 1.0
    np.testing.assert_allclose(got_x.float().numpy(), np.asarray(want_x, np.float32),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)


def test_train_pipeline_float_precrop_on_cpu_matches_jax(monkeypatch):
    """A float precrop batch runs the planes path on the CPU (the kernel
    takes uint8 only), NCHW output, no mixup."""
    B, (H, W), out = 3, (30, 30), (24, 24)
    x = structured_images(7, B, H, W).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[[0, 1, 2]]
    key = jax.random.PRNGKey(4)
    inject_draws(monkeypatch, [jax_pipeline_draws(key, B, (H, W), out, AUG_CFG, (0.0, 0.3))])
    want_x, _ = jaug.train_pipeline(key, jnp.asarray(x), jnp.asarray(oh), out, **AUG_CFG)
    got_x, got_y = taug.train_pipeline(torch.Generator(), torch.from_numpy(x),
                                       torch.from_numpy(oh), out, **AUG_CFG)
    assert tuple(got_x.shape) == (B, 3, *out) and got_y is not None
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="A5b"):
        taug.train_pipeline(torch.Generator(), torch.from_numpy(x), torch.from_numpy(oh),
                            out, internal_layout="HWC", **AUG_CFG)


def test_draws_follow_the_generator_and_their_ranges():
    """The same seed gives the same draws; they lie in the configured
    ranges; only the configured stages draw."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return taug.draw_batch_params(g, 64, (40, 44), (32, 32), **AUG_CFG), \
            taug.draw_mixup(g, 64, 0.0, 0.3)

    (p1, (lam1, perm1)), (p2, (lam2, perm2)) = draw(1), draw(1)
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    assert torch.equal(lam1, lam2) and torch.equal(perm1, perm2)
    assert int(p1["crop_r"].max()) < 8 and int(p1["crop_c"].max()) < 12
    assert int(p1["crop_r"].min()) >= 0
    s = p1["hsv_scales"]
    assert bool((s[:, 0] >= 0.9).all() and (s[:, 0] < 1.1).all() and (s[:, 1:] >= 0.5).all())
    assert bool((p1["deg"].abs() <= 15).all()) and p1["flip"].dtype == torch.bool
    assert 0.0 <= float(lam1) < 0.3 and sorted(perm1.tolist()) == list(range(64))
    assert set(taug.draw_batch_params(torch.Generator(), 2, (30, 30), (24, 24),
                                      crop_mode="center")) == set()


def test_mixup_pair_matches_jax_arithmetic():
    rng = np.random.RandomState(8)
    X = rng.randn(6, 5, 5, 3).astype(np.float32) * 100
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 6)]
    lam, perm = np.float32(0.23), rng.permutation(6)
    Xm, ym = X[perm], y[perm]
    got_x, got_y = taug.mixup_pair(torch.from_numpy(X), torch.from_numpy(y),
                                   torch.tensor(lam), torch.from_numpy(perm))
    want_x = np.concatenate([lam * Xm + (1 - lam) * X, lam * X + (1 - lam) * Xm])
    want_y = np.concatenate([lam * ym + (1 - lam) * y, lam * y + (1 - lam) * ym])
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
