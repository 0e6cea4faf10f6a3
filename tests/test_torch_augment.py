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
from dorknet_tpu_torch.ops.augment import shear_coefs, shear_pad  # noqa: E402
from dorknet_tpu_torch.ops.cuda.augment import (  # noqa: E402
    BAND_COLS, BAND_ROWS, augment_param_table, augment_planes_fused,
    augment_planes_fused_plain, band_plan, band_tile, band_windows, fit_band,
    t_hi_of)

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
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
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


# the band route's windows: (oh, ow), the rotation range the margin P is
# sized for, the largest angle drawn, tiles (rows, columns), and whether
# some tile's windows exceed the plan (its direct path). P = 32 at the
# flagship's 225 px; P >= 33 in the rest, where t_hi > 2P. With angles inside
# the range P was sized for, every window fits the plan and no shift reaches
# 3P, so no read wraps to content; a table with larger angles (100 px, P
# from +-40 degrees, angles to +-90) makes the second shear of a bottom band
# read the top rows of the image, and its tiles exceed the plan
BAND_CASES = [((225, 225), 15.0, 15.0, ((32, 64), (16, 128)), False),
              ((225, 225), 20.0, 20.0, ((32, 64),), False),
              ((100, 100), 40.0, 90.0, ((32, 64), (16, 16)), True),
              ((64, 64), 90.0, 90.0, ((8, 16), (32, 64)), False),
              ((320, 320), 15.0, 15.0, ((32, 64),), False),
              ((29, 33), 15.0, 15.0, ((4, 8), (32, 64)), False)]
BAND_IDS = ["225_15", "225_20", "100_40_angles90_wraps", "64_90", "320_15", "29x33_15"]
H100_BLOCK_SMEM = 232448  # the shared memory an H100 block can opt into


def _plain_shifts(coef, coords, P):
    """Integer shifts of lines at fp32 coordinates for coefficients coef
    (B,), as shear_rotate_planes computes them: (B, lines)."""
    t = coef.view(-1, 1) * coords.view(1, -1) + P
    return torch.floor(torch.clamp(t, 0.0, float(t_hi_of(P)))).long()


def _seeded_coefs(seed, deg_max, n=6):
    """a, b of n seeded angles in [-deg_max, deg_max], the two ends included."""
    deg = np.random.RandomState(seed).uniform(-deg_max, deg_max, n).astype(np.float32)
    deg[:2] = (-deg_max, deg_max)
    return shear_coefs(torch.from_numpy(deg))


def _in_window(idx, window, period):
    return bool((((idx - window[0]) % period) < window[1]).all())


@pytest.mark.parametrize("size,pad_deg,deg_max,tiles,exceeds", BAND_CASES, ids=BAND_IDS)
def test_band_windows_hold_every_read_of_the_three_shears(size, pad_deg, deg_max, tiles,
                                                          exceeds):
    """Brute force with the plain version's fp32 shifts, for every tile and
    seeded angle: the third shear's reads (x + t0[y] and the next, modulo
    Wp) lie in J, the second shear's over J (y + t0[j] and the next, modulo
    Hp) in R, the first shear's over the content rows of R (j + t0[c] - P
    and the next) in K. With angles inside the margin's range the windows
    fit the plan; where the case says so, some tile's exceed it (the
    kernel's direct path), and some window of R wraps to the top rows."""
    oh, ow = size
    P = shear_pad((-pad_deg, pad_deg), oh, ow)
    Wp, Hp = ow + 2 * P, oh + 2 * P
    a, b = _seeded_coefs(oh + ow, deg_max)
    t_rows = _plain_shifts(a, torch.arange(oh, dtype=torch.float32) - oh / 2.0, P)
    t_cols = _plain_shifts(b, torch.arange(Wp, dtype=torch.float32) - P - ow / 2.0, P)
    over = wrapped = False
    for th, tw in tiles:
        caps = band_plan(oh, ow, P, th, tw)[:3]
        for i in range(len(a)):
            for y0 in range(0, oh, th):
                for x0 in range(0, ow, tw):
                    y1, x1 = min(y0 + th, oh), min(x0 + tw, ow)
                    wj, wr, wk = band_windows(float(a[i]), float(b[i]), oh, ow, P, (y0, y1),
                                              (x0, x1))
                    over |= any(w[1] > cap for w, cap in zip((wj, wr, wk), caps))
                    y = torch.arange(y0, y1).view(-1, 1)
                    k3 = torch.arange(x0, x1).view(1, -1) + t_rows[i, y0:y1].view(-1, 1)
                    assert _in_window(torch.cat([k3 % Wp, (k3 + 1) % Wp]), wj, Wp)
                    j = (wj[0] + torch.arange(wj[1])) % Wp
                    q = y + t_cols[i, j].view(1, -1)
                    assert _in_window(torch.cat([q % Hp, (q + 1) % Hp]), wr, Hp)
                    p = (wr[0] + torch.arange(wr[1])) % Hp
                    c = p[(p >= P) & (p < P + oh)] - P
                    wrapped |= bool(((q + 1 >= Hp + P) & (q + 1 < Hp + P + oh)).any())
                    k1 = j.view(1, -1) + t_rows[i, c].view(-1, 1) - P
                    assert _in_window(torch.cat([k1 % Wp, (k1 + 1) % Wp]), wk, Wp)
    assert over == exceeds
    assert wrapped == exceeds


def _lerp_u8(v0, v1, frac):
    """The shears' lerp in fp32, every operation rounded, half up to uint8."""
    f = np.float32(frac)
    v = (np.float32(1.0) - f) * v0.astype(np.float32) + f * v1.astype(np.float32)
    return np.clip(v + np.float32(0.5), 0, 255).astype(np.uint8)


def _line_shift(coef, coord, P):
    t = np.float32(np.float32(coef) * np.float32(coord)) + np.float32(P)
    t = min(max(t, np.float32(0.0)), np.float32(t_hi_of(P)))
    return int(np.floor(t)), np.float32(t - np.floor(t))


def _band_route(planes, a, b, flip, P, tile):
    """The band route's algorithm (csrc/augment_planes.cu,
    augment_band_kernel) in numpy on cropped (and HSV) planes (B,3,oh,ow):
    per tile, only the K columns of the R rows go through the first shear,
    into slots of their windows, and the second and third shears read them
    there, each read's slot its unwrapped index minus the window's start; a
    tile whose windows exceed the plan reads through the three shears from
    the planes directly, as the kernel's direct path does."""
    B, C, oh, ow = planes.shape
    Wp, Hp = ow + 2 * P, oh + 2 * P
    cy, cx = np.float32(0.5 * oh), np.float32(0.5 * ow)
    th, tw = tile
    caps = band_plan(oh, ow, P, th, tw)[:3]
    out = np.zeros_like(planes)
    direct = 0
    padded = np.zeros((B, C, Hp, Wp), np.uint8)  # the direct path's reads
    padded[:, :, P:P + oh, P:P + ow] = planes

    def slots(k, w):
        d = k - w[0]
        assert (d >= 0).all() and (d < w[1]).all()
        return d

    for n in range(B):
        cols = [_line_shift(b[n], np.float32(j - P) - cx, P) for j in range(Wp)]
        t_c = np.array([t for t, _ in cols])
        f_c = np.array([f for _, f in cols], np.float32)
        rows = [_line_shift(a[n], np.float32(c) - cy, P) for c in range(oh)]
        for y0 in range(0, oh, th):
            for x0 in range(0, ow, tw):
                y1, x1 = min(y0 + th, oh), min(x0 + tw, ow)
                wj, wr, wk = band_windows(a[n], b[n], oh, ow, P, (y0, y1), (x0, x1))
                j_u = wj[0] + np.arange(wj[1])  # J's unwrapped columns
                j = j_u % Wp
                staged = all(w[1] <= cap for w, cap in zip((wj, wr, wk), caps))
                direct += not staged
                sa = np.zeros((C, wr[1], wj[1]), np.uint8)
                k_cols = (wk[0] + np.arange(wk[1])) % Wp
                for rr in range(wr[1]):
                    p = (wr[0] + rr) % Hp
                    if not P <= p < P + oh:
                        continue
                    t0, fr = rows[p - P]
                    k_u = j_u + t0 - P
                    if staged:
                        line, s0 = padded[n, :, p][:, k_cols], slots(k_u, wk)
                        v0, v1 = line[:, s0], line[:, s0 + 1]
                    else:
                        v0, v1 = padded[n, :, p][:, k_u % Wp], padded[n, :, p][:, (k_u + 1) % Wp]
                    sa[:, rr] = _lerp_u8(v0, v1, fr)
                for y in range(y0, y1):
                    q = slots(y + t_c[j], wr)
                    jj = np.arange(wj[1])
                    rowb = _lerp_u8(sa[:, q, jj], sa[:, q + 1, jj], f_c[j])
                    t0, fr = rows[y]
                    xs = np.arange(x0, x1)
                    s3 = slots(xs + t0, wj)
                    val = _lerp_u8(rowb[:, s3], rowb[:, s3 + 1], fr)
                    out[n, :, y][:, ow - 1 - xs if flip[n] else xs] = val
    return out, direct


@pytest.mark.parametrize("size,pad_deg,deg_max,tile", [
    ((29, 33), 15.0, 15.0, (8, 16)), ((64, 64), 90.0, 90.0, (16, 32)),
    ((100, 100), 40.0, 90.0, (32, 64))],
    ids=["29x33_15", "64_90", "100_40_angles90_wraps"])
def test_band_route_algorithm_is_bit_equal_to_the_plain_version(size, pad_deg, deg_max, tile):
    """The band route's windows and slots, run in numpy, give the plain
    version's rotation and flip exactly: at P < 33, at P >= 33, and with
    angles beyond the range the margin was sized for, where some tiles take
    the direct path."""
    oh, ow = size
    B, H, W = 2, oh + 6, ow + 4
    cfg = dict(AUG_CFG, rotation_tuple=(-deg_max, deg_max))
    x = torch.from_numpy(structured_images(oh, B, H, W))
    params = taug.draw_batch_params(torch.Generator().manual_seed(5), B, (H, W), (oh, ow),
                                    **cfg)
    params["deg"][:2] = torch.tensor([deg_max, -deg_max * 0.7])
    params["flip"][:2] = torch.tensor([True, False])
    table = augment_param_table(params, B, (H, W), (oh, ow), **cfg)
    P = shear_pad((-pad_deg, pad_deg), oh, ow)
    want = augment_planes_fused_plain(x, table, (oh, ow), True, P, True).numpy()
    planes = augment_planes_fused_plain(x, table, (oh, ow), True, 0, False).numpy()
    got, direct = _band_route(planes, table[:, 5].numpy(), table[:, 6].numpy(),
                              table[:, 7].numpy() != 0, P, tile)
    np.testing.assert_array_equal(got, want)
    assert (direct > 0) == (deg_max > pad_deg)


def test_band_plan_fits_sizes_the_plane_route_refused():
    """At 320 x 320 (+-15 and +-45 degrees), where two whole stage planes
    would exceed an H100 block's shared memory, the band route's plan fits
    with the default tile. fit_band halves a tile (its longer side) only
    where it must, and gives caps of 0 (every tile direct) where not even one pixel's
    plan fits."""
    for deg in (15.0, 45.0):
        P = shear_pad((-deg, deg), 320, 320)
        th, tw, *caps = fit_band(320, 320, P, H100_BLOCK_SMEM)
        assert (th, tw) == (45, 75) and band_plan(320, 320, P)[:3] == tuple(caps)
        assert band_plan(320, 320, P)[3] <= H100_BLOCK_SMEM
    cap_j, cap_r, cap_k, smem = band_plan(225, 225, 32)
    assert (cap_j, cap_r, cap_k) == (89, 71, 110) and smem < 32 * 1024
    assert fit_band(225, 225, 32, smem)[:2] == (45, 75)
    assert fit_band(225, 225, 32, smem - 1)[:2] == (45, 37)
    assert fit_band(225, 225, 32, 64)[2:] == (0, 0, 0)


@pytest.mark.parametrize("size,want", [((225, 225), (45, 75)), ((281, 281), (41, 71)),
                                       ((100, 100), (34, 50)), ((29, 33), (29, 33)),
                                       ((320, 320), (40, 64))])
def test_band_tile_cuts_each_side_into_equal_parts(size, want):
    """The default tile: at most BAND_ROWS x BAND_COLS, each side the
    length over the fewest parts that fit (225 = 5 x 45 = 3 x 75), so no
    band or column chunk is a sliver."""
    assert band_tile(*size) == want
    for n, t, cap in zip(size, want, (BAND_ROWS, BAND_COLS)):
        parts = -(-n // cap)  # the fewest parts of at most cap
        assert t <= cap and -(-n // t) == parts and (parts - 1) * t < n
