"""The port's CUDA kernels on the card. These tests skip without a CUDA
device; on the GPU machine (which has no jax, so the suite's conftest cannot
load there) run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

from dorknet_tpu_torch.data_loading.device_augment import (  # noqa: E402
    draw_batch_params, train_pipeline)
from dorknet_tpu_torch.models import MobileNetV3Large, ResNet18  # noqa: E402
from dorknet_tpu_torch.network import Trainer  # noqa: E402
from dorknet_tpu_torch.ops.augment import shear_pad  # noqa: E402
from dorknet_tpu_torch.ops.cuda.augment import (  # noqa: E402
    augment_param_table, augment_planes_fused, augment_planes_fused_plain,
    launch_augment_kernel)
from dorknet_tpu_torch.ops.cuda.bn_stats import (  # noqa: E402
    batch_norm_stats, batch_norm_stats_plain)
from dorknet_tpu_torch.ops import norm as norm_ops  # noqa: E402
from dorknet_tpu_torch.ops.activation import hard_sigmoid  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bias_act import bias_act, bias_act_plain  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bn_train import (  # noqa: E402
    _dy, bn_apply, bn_apply_plain, bn_bwd_dx, bn_bwd_dx_plain, bn_bwd_reduce)
from dorknet_tpu_torch.ops.cuda.depthwise import (  # noqa: E402
    _dw_route, _dwgrad_route, _dx_route, depthwise3x3, depthwise3x3_dw, depthwise3x3_dw_plain,
    depthwise3x3_dx, depthwise3x3_dx_plain, depthwise3x3_plain, launch_dw, launch_dx,
    launch_forward)
from dorknet_tpu_torch.ops.cuda.depthwise7x7 import (  # noqa: E402
    Depthwise7x7Fn, depthwise7x7_dw, depthwise7x7_dw_plain)
from dorknet_tpu_torch.ops.cuda.matmul import (  # noqa: E402
    PIPELINED_TILES, _gemm_route, _gemm_tile, launch_matmul, launch_matmul_bn_stats, matmul,
    matmul_bn_stats, matmul_bn_stats_plain, matmul_plain)
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", [
    (2, 9, 9, 24, 1), (2, 9, 9, 24, 2), (3, 10, 7, 5, 2), (1, 1, 1, 3, 1),
    (2, 2, 3, 1, 2), (4, 16, 16, 40, 1),
])
def test_kernel_matches_plain(cuda, N, H, W, C, stride, dtype):
    """fp32: rtol 1e-5 of max|y| (FMA against separate multiply-adds);
    bf16 with bf16-exact weights: both round the same fp32 sums."""
    g = torch.Generator(device=cuda).manual_seed(N * 1000 + H * 10 + C)
    x = torch.randn(N, H, W, C, generator=g, device=cuda).to(dtype)
    w = torch.randn(C, 3, 3, generator=g, device=cuda).to(dtype).float()
    before = depthwise3x3.launches
    y = depthwise3x3(x, w, stride)
    ref = depthwise3x3_plain(x, w, stride)
    torch.cuda.synchronize()
    assert depthwise3x3.launches == before + 1
    assert y.dtype == dtype and y.shape == ref.shape
    tol = 1e-5 * float(ref.float().abs().max()) + 1e-6 if dtype == torch.float32 else 0.0
    assert float((y.float() - ref.float()).abs().max()) <= tol


def test_kernel_refuses_grad_and_mixed_devices(cuda):
    """An input that needs a gradient trains through the forward, dx and dw
    kernels (one launch each); mixed devices are refused."""
    x = torch.randn(1, 5, 5, 4, device=cuda, requires_grad=True)
    w = torch.randn(4, 3, 3, device=cuda, requires_grad=True)
    before = (depthwise3x3.launches, depthwise3x3_dx.launches, depthwise3x3_dw.launches)
    depthwise3x3(x, w, 1).square().sum().backward()
    torch.cuda.synchronize()
    assert (depthwise3x3.launches, depthwise3x3_dx.launches,
            depthwise3x3_dw.launches) == tuple(n + 1 for n in before)
    g = 2 * depthwise3x3_plain(x.detach(), w.detach(), 1)
    for got, want in ((x.grad, depthwise3x3_dx_plain(g, w.detach(), 1, 5, 5)),
                      (w.grad, depthwise3x3_dw_plain(x.detach(), g, 1))):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-5
    with torch.inference_mode():
        assert depthwise3x3(x, w, 1).shape == (1, 5, 5, 4)
    with pytest.raises(ValueError, match="x on"):
        depthwise3x3(x.detach(), w.detach().cpu(), 1)


BWD_CASES = [(2, 9, 9, 24, 1), (2, 9, 9, 24, 2), (3, 10, 7, 5, 2), (1, 1, 1, 3, 1),
             (2, 2, 3, 1, 2), (4, 16, 16, 40, 1), (2, 14, 14, 64, 2), (2, 8, 8, 33, 2)]


def _bwd_inputs(device, N, H, W, C, stride, dtype):
    g_ = torch.Generator(device=device).manual_seed(N * 1000 + H * 10 + C + stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(N, H, W, C, generator=g_, device=device).to(dtype)
    g = torch.randn(N, Ho, Wo, C, generator=g_, device=device).to(dtype)
    w = torch.randn(C, 3, 3, generator=g_, device=device).to(dtype).float()
    return x, g, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", BWD_CASES)
def test_dx_kernel_matches_plain(cuda, N, H, W, C, stride, dtype):
    """fp32: 1e-5 of max|dx|; bf16 with bf16-exact weights: the products
    are exact and both sum the taps in the same order, so equal."""
    _, g, w = _bwd_inputs(cuda, N, H, W, C, stride, dtype)
    before = depthwise3x3_dx.launches
    dx = depthwise3x3_dx(g, w, stride, H, W)
    ref = depthwise3x3_dx_plain(g, w, stride, H, W)
    torch.cuda.synchronize()
    assert depthwise3x3_dx.launches == before + 1
    assert dx.dtype == dtype and dx.shape == (N, H, W, C)
    tol = 1e-5 * float(ref.float().abs().max()) + 1e-6 if dtype == torch.float32 else 0.0
    assert float((dx.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", BWD_CASES)
def test_dw_kernel_matches_plain_and_repeats(cuda, N, H, W, C, stride, dtype):
    """Within 2e-5 of sum|x*g| per tap and channel (fp32 sums in another
    order); two runs bit-equal."""
    x, g, _ = _bwd_inputs(cuda, N, H, W, C, stride, dtype)
    before = depthwise3x3_dw.launches
    dw = depthwise3x3_dw(x, g, stride)
    dw2 = depthwise3x3_dw(x, g, stride)
    ref = depthwise3x3_dw_plain(x, g, stride)
    scale = depthwise3x3_dw_plain(x.float().abs(), g.float().abs(), stride)
    torch.cuda.synchronize()
    assert depthwise3x3_dw.launches == before + 2
    assert dw.dtype == torch.float32 and dw.shape == (C, 3, 3)
    assert torch.equal(dw, dw2)
    assert bool(((dw - ref).abs() <= 2e-5 * scale + 1e-6).all())


def test_resnet18_on_card_matches_cpu(cuda):
    """fp32 with TF32 off: the served probs on the card equal the CPU
    forward's within 1e-5, and all 16 depthwise layers launched the kernel."""
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    seed_serving_weights(net, seed=0, calib_hw=(33, 33))
    X = np.random.RandomState(1).randn(3, 3, 33, 33).astype(np.float32)
    _, want = net.forward(X, test_mode=True)
    net.to(cuda)
    before = depthwise3x3.launches
    _, got = net.forward(X, test_mode=True)
    assert depthwise3x3.launches == before + 16
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_folded_serving_predict_iter_and_export_on_card(cuda, tmp_path):
    """fold_bn on the card: the folded runner serves the CPU folded runner's
    probs within 1e-5 with 16 depthwise launches a dispatch; predict_iter
    through the pinned rings streams predict_probs's probs and passes the
    labels through; the fixed and polymorphic programs, reloaded, launch the
    kernel 16 times a dispatch through dorknet::depthwise3x3 and serve the
    runner's probs within 1e-6."""
    from dorknet_tpu_torch.network import InferenceRunner, load_serving_artifact

    np.random.seed(0)
    net = ResNet18("dogs", num_classes=10)
    seed_serving_weights(net, seed=0, calib_hw=(33, 33))
    X = np.random.RandomState(1).randn(11, 3, 33, 33).astype(np.float32)
    want = InferenceRunner(net, batch_size=4, device="cpu", fold_bn=True).predict_probs(X)
    runner = InferenceRunner(net, batch_size=4, device=cuda, fold_bn=True)
    before = depthwise3x3.launches
    got = runner.predict_probs(X)
    assert depthwise3x3.launches == before + 16 * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    labels = np.arange(11)
    out = list(runner.predict_iter(iter([(X[i:i + 4], labels[i:i + 4])
                                         for i in range(0, 11, 4)])))
    np.testing.assert_array_equal(np.concatenate([o[0] for o in out]), got)
    assert all(o[1].device.type == "cuda" for o in out)
    np.testing.assert_array_equal(np.concatenate([o[1].cpu().numpy() for o in out]), labels)
    ins, probs = runner.pinned_rings
    assert (ins.slots, ins.allocations, probs.slots, probs.allocations) == (3, 6, 2, 2)
    for poly in (False, True):
        path = str(tmp_path / "a{}.pt2".format(int(poly)))
        runner.export_program((33, 33), path=path, polymorphic_batch=poly)
        art = load_serving_artifact(path, max_batch=4)
        assert art.platforms == ("cuda",) and art.polymorphic_batch == poly
        before = depthwise3x3.launches
        p = art.predict_probs(X)
        torch.cuda.synchronize()
        assert depthwise3x3.launches == before + 16 * 3
        np.testing.assert_allclose(p, got, rtol=0, atol=1e-6)


def test_trainer_step_on_card_matches_cpu(cuda):
    """ResNet18 at full width, fresh BN, two eager Trainer.steps (clip 1.0, EMA
    0.9) at batch 4 at the flagship's 225 px on the card and on the CPU
    (fp32, TF32 off): per-step loss within 1e-4 relative, parameters within
    1e-4 relative / 1e-5 absolute, and every step launched the forward, dx
    and dw kernels 16 times each, all on their channel-vector routes. Why
    this configuration: the fresh weights
    are 0.01-scale and each BN divides by a small sigma, so the stem's
    gradients are large; without the clip one step moves those weights by
    about their own size, and the 1e-3-relative fp32 differences between
    the devices' cancelling reductions (BN backward, weight gradients) then
    reach 9e-5 absolute. Below 225 px the last stages' BNs see only a few
    samples and the second step's loss moves by 1.4e-4 relative."""
    np.random.seed(0)
    net_cpu = ResNet18("dogs", num_classes=120)
    np.random.seed(0)
    net_gpu = ResNet18("dogs", num_classes=120)
    args = dict(ema_decay=0.9, clip_norm=1.0)
    t_cpu = Trainer(net_cpu, SGDMomentum(net_cpu, 0.001, 0.9), device="cpu", **args)
    # eager: a captured step is a replay, which moves no launch counter
    t_gpu = Trainer(net_gpu, SGDMomentum(net_gpu, 0.001, 0.9), device=cuda, cuda_graph=False,
                    **args)
    rng = np.random.RandomState(1)
    for _ in range(2):
        X = rng.randn(4, 3, 225, 225).astype(np.float32)
        y = np.eye(120, dtype=np.float32)[rng.randint(0, 120, 4)]
        want, _ = t_cpu.step(X, y)
        kernels = (depthwise3x3, depthwise3x3_dx, depthwise3x3_dw)
        counts = [k.launches for k in kernels]
        routes = [dict(k.launches_by_route) for k in kernels]
        got, _ = t_gpu.step(X, y)
        torch.cuda.synchronize()
        assert [k.launches for k in kernels] == [n + 16 for n in counts]
        assert [dict(k.launches_by_route) for k in kernels] == [
            {"scalar": r["scalar"], "vector": r["vector"] + 16} for r in routes]
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    for a, b in zip(net_gpu.parameters(), net_cpu.parameters(), strict=True):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


AUG_CFG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)),
               rotation_tuple=(-15.0, 15.0), horizontal_flip_prob=0.5, crop_mode="random")
AUG_CONFIGS = [AUG_CFG, dict(AUG_CFG, crop_mode="center"), dict(AUG_CFG, rotation_tuple=None),
               dict(AUG_CFG, hsv_pert_tuples=None),
               dict(hsv_pert_tuples=None, rotation_tuple=None, horizontal_flip_prob=None,
                    crop_mode="random"),
               dict(AUG_CFG, crop_mode=None)]


def _precrop_batch(device, B, H, W, seed):
    """uint8 (B,H,W,3): a smooth pattern per channel plus noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(H, device=device).view(1, H, 1, 1).float()
    xx = torch.arange(W, device=device).view(1, 1, W, 1).float()
    base = 127 + 60 * torch.sin(yy / 9.0 + torch.arange(3, device=device)) + 50 * torch.cos(xx / 13.0)
    noise = torch.randint(-40, 41, (B, H, W, 3), generator=g, device=device)
    return torch.clamp(base + noise, 0, 255).to(torch.uint8)


@pytest.mark.parametrize("cfg", AUG_CONFIGS, ids=["all", "center", "no_rotation", "no_hsv",
                                                  "crop_only", "no_crop"])
@pytest.mark.parametrize("B,H,W,out", [(4, 40, 40, (32, 32)), (3, 37, 45, (29, 33)),
                                       (2, 281, 281, (225, 225))])
def test_augment_kernel_matches_plain(cuda, B, H, W, out, cfg):
    """The kernel and its plain version on the card, from the same draws:
    bit-equal (both round every operation the same way), one launch."""
    x = _precrop_batch(cuda, B, H, W, seed=B * H + W)
    p = draw_batch_params(torch.Generator(device=cuda).manual_seed(3), B, (H, W), out, **cfg)
    before = augment_planes_fused.launches
    got = augment_planes_fused(x, p, out, **cfg)
    want = augment_planes_fused(x.cpu(), {k: v.cpu() for k, v in p.items()}, out, **cfg)
    torch.cuda.synchronize()
    assert augment_planes_fused.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_augment_kernel_refuses_float_and_large_rotations(cuda):
    """A float precrop batch on the card raises (the kernel is uint8-only),
    in the wrapper and through train_pipeline. A 320 x 320 rotation, whose
    whole stage planes would exceed a block's shared memory, runs in tiles
    and equals the plain version."""
    p = draw_batch_params(torch.Generator(device=cuda), 2, (30, 30), (24, 24), **AUG_CFG)
    xf = torch.zeros((2, 30, 30, 3), device=cuda)
    with pytest.raises(TypeError, match="uint8"):
        augment_planes_fused(xf, p, (24, 24), **AUG_CFG)
    with pytest.raises(TypeError, match="uint8"):
        train_pipeline(torch.Generator(device=cuda), xf, torch.zeros((2, 3), device=cuda),
                       (24, 24), **AUG_CFG)
    big = _precrop_batch(cuda, 1, 330, 330, seed=5)
    pb = draw_batch_params(torch.Generator(device=cuda).manual_seed(1), 1, (330, 330),
                           (320, 320), **AUG_CFG)
    before = augment_planes_fused.launches
    got = augment_planes_fused(big, pb, (320, 320), **AUG_CFG)
    want = augment_planes_fused(big.cpu(), {k: v.cpu() for k, v in pb.items()}, (320, 320),
                                **AUG_CFG)
    torch.cuda.synchronize()
    assert augment_planes_fused.launches == before + 1
    assert torch.equal(got.cpu(), want)


# the band route against the plain version: the cases
# of test_augment_kernel_matches_plain with rotation, a P >= 33 one (100 px,
# +-40 degrees), and one whose table holds angles beyond the range its margin
# was sized for, so that the second shear of a bottom band reads the top rows
# and some tiles exceed the plan
BAND_CASES = [(4, 40, 40, (32, 32), 15.0, 15.0), (3, 37, 45, (29, 33), 15.0, 15.0),
              (2, 281, 281, (225, 225), 15.0, 15.0), (2, 110, 110, (100, 100), 40.0, 40.0),
              (2, 110, 110, (100, 100), 40.0, 90.0)]


@pytest.mark.parametrize("tile", [None, (32, 64), (16, 128), (1, 1)])
@pytest.mark.parametrize("B,H,W,out,pad_deg,deg_max", BAND_CASES,
                         ids=["40", "37x45", "281", "100_P35", "100_wraps"])
def test_band_route_equals_plain(cuda, B, H, W, out, pad_deg, deg_max, tile):
    """Bit-equal to the plain version, with HSV and flip, at several tiles
    (the last case's tiles partly on the direct path); one launch."""
    cfg = dict(AUG_CFG, rotation_tuple=(-deg_max, deg_max))
    x = _precrop_batch(cuda, B, H, W, seed=B * H + W)
    p = draw_batch_params(torch.Generator(device=cuda).manual_seed(4), B, (H, W), out, **cfg)
    table = augment_param_table(p, B, (H, W), out, device=cuda, **cfg)
    P = shear_pad((-pad_deg, pad_deg), *out)
    before = augment_planes_fused.launches
    got = launch_augment_kernel(x, table, out, True, P, tile=tile)
    want = augment_planes_fused_plain(x.cpu(), table.cpu(), out, True, P, True)
    torch.cuda.synchronize()
    assert augment_planes_fused.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _within_stats_limit(mean, var, ref_mean, ref_var, rtol=2e-5):
    """Per channel: mean within rtol x sqrt(E[x^2]), var within rtol x
    E[x^2] (the scales of the fp32 sums' rounding), E[x^2] from the
    reference."""
    e2 = (ref_var + ref_mean * ref_mean).double()
    return bool(((mean - ref_mean).abs().double() <= rtol * e2.sqrt() + 1e-12).all()
                and ((var - ref_var).abs().double() <= rtol * e2 + 1e-12).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,shift", [
    ((2, 9, 9, 24), 0.0), ((3, 5, 5, 7), 7.0), ((1, 1, 1, 1), 0.0), ((300, 40), -2.0),
    ((8, 7, 7, 512), 0.0), ((2, 112, 112, 64), 7.0), ((4, 33, 33, 64), 0.0),
])
def test_bn_stats_kernel_matches_plain_and_repeats(cuda, shape, shift, dtype):
    """Two launches, bit-equal; within the statistics' limits of the plain
    version and of an fp64 reference."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn(*shape, generator=g, device=cuda) * 1.5 + shift).to(dtype)
    before = batch_norm_stats.launches
    mean, var = batch_norm_stats(x)
    mean2, var2 = batch_norm_stats(x)
    ref_mean, ref_var = batch_norm_stats_plain(x)
    dims = tuple(range(x.dim() - 1))
    x64 = x.double()
    mean64 = x64.mean(dim=dims)
    var64 = ((x64 - mean64) ** 2).mean(dim=dims)
    torch.cuda.synchronize()
    assert batch_norm_stats.launches == before + 2
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (shape[-1],)
    assert torch.equal(mean, mean2) and torch.equal(var, var2)
    assert _within_stats_limit(mean, var, ref_mean, ref_var)
    assert _within_stats_limit(mean.double(), var.double(), mean64, var64)


def test_bn_stats_kernel_refuses_what_it_does_not_take(cuda):
    before = batch_norm_stats.launches
    with pytest.raises(ValueError, match="contiguous"):
        batch_norm_stats(torch.zeros(4, 6, 8, device=cuda).transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        batch_norm_stats(torch.zeros(4, 8, device=cuda, dtype=torch.float16))
    assert batch_norm_stats.launches == before


# every width of MobileNet-V3-Large's batch norms, the flagship's other
# three, an odd C (the scalar route) and ResNet-50's widest
BN_TRAIN_WIDTHS = [16, 24, 40, 64, 72, 80, 112, 120, 160, 184, 200, 240, 480, 672, 960,
                   128, 256, 512, 13, 2048]
BN_SUM_RTOL = 2e-5  # of the sum of the terms' magnitudes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", BN_TRAIN_WIDTHS)
def test_bn_train_kernels_match_plain_and_repeat(cuda, C, dtype):
    """At 4 x 24 x 24 x C: bn_apply's y and (mean, inv) and bn_bwd_dx's dx
    bit-equal to their plain versions (every fp32 operation rounded on its
    own, in the same order); bn_bwd_reduce's dbeta and dgamma within
    BN_SUM_RTOL of the terms' magnitudes of fp64 sums of the same terms,
    and its factors formed from them as the plain version forms them; two
    launches of each bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(C)
    shape = (4, 24, 24, C)
    x = (torch.randn(*shape, generator=g, device=cuda) * 1.5 + 0.25).to(dtype)
    gy = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device=cuda)
    beta = 0.1 * torch.randn(C, generator=g, device=cuda)
    mean, var = batch_norm_stats(x)
    entries = (bn_apply, bn_bwd_reduce, bn_bwd_dx)
    before = [k.launches for k in entries]
    (y, norm), (y2, norm2) = (bn_apply(x, mean, var, gamma, beta, 1e-5) for _ in range(2))
    y_ref, norm_ref = bn_apply_plain(x, mean, var, gamma, beta, 1e-5)
    (dgamma, dbeta, coef), again = (bn_bwd_reduce(gy, x, norm, gamma) for _ in range(2))
    dx, dx2 = (bn_bwd_dx(gy, x, norm, coef) for _ in range(2))
    dx_ref = bn_bwd_dx_plain(gy, x, norm, coef)
    M = x.numel() // C
    g64 = gy.double().reshape(M, C)
    t64 = g64 * ((x.float() - norm[0]) * norm[1]).to(dtype).double().reshape(M, C)
    count = torch.full_like(dbeta, float(M))
    torch.cuda.synchronize()
    assert [k.launches for k in entries] == [b + 2 for b in before]
    assert y.dtype == dx.dtype == dtype and norm.shape == (2, C) and coef.shape == (3, C)
    assert torch.equal(y, y_ref) and torch.equal(norm, norm_ref) and torch.equal(dx, dx_ref)
    assert torch.equal(y, y2) and torch.equal(norm, norm2) and torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip((dgamma, dbeta, coef), again, strict=True))
    assert ((dbeta.double() - g64.sum(0)).abs() <= BN_SUM_RTOL * g64.abs().sum(0)).all()
    assert ((dgamma.double() - t64.sum(0)).abs() <= BN_SUM_RTOL * t64.abs().sum(0)).all()
    assert torch.equal(coef, torch.stack([gamma * norm[1], dbeta / count, dgamma / count]))


def test_bn_train_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    ones = torch.ones(8, device=cuda)
    norm2, coef = torch.zeros(2, 8, device=cuda), torch.zeros(3, 8, device=cuda)
    before = [k.launches for k in (bn_apply, bn_bwd_reduce, bn_bwd_dx)]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn_apply(x.half(), ones, ones, ones, ones, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        bn_bwd_dx(x, torch.zeros(8, 4, device=cuda).t(), norm2, coef)
    with pytest.raises(ValueError, match="gamma must be contiguous float32"):
        bn_bwd_reduce(x, x, norm2, ones[:7])
    with pytest.raises(ValueError, match="is on cpu"):
        bn_apply(x, ones, ones, ones.cpu(), ones, 1e-5)
    assert [k.launches for k in (bn_apply, bn_bwd_reduce, bn_bwd_dx)] == before


# hand kernels of a train-mode batch norm, by name: each launched once a
# batch norm in a training step
BN_TRAIN_KERNELS = ("bn_stats_partial_kernel", "bn_apply_kernel", "bn_bwd_reduce_kernel",
                    "bn_bwd_finish_kernel", "bn_bwd_dx_kernel")


@pytest.mark.parametrize("make,classes,bns", [
    (lambda: ResNet18("dogs", num_classes=120), 120, 34),
    (lambda: MobileNetV3Large("mnv3l", num_classes=1000), 1000, 46),
], ids=["resnet18dw", "mnv3l"])
def test_captured_step_launches_the_bn_kernels_once_a_batch_norm(cuda, make, classes, bns):
    """One replay of a captured Trainer.step (2 images of 64 px), profiled:
    every train-mode batch norm launches batch_norm_stats, bn_apply,
    bn_bwd_reduce (pass 1 and its finish) and bn_bwd_dx once each, by
    kernel name."""
    np.random.seed(0)
    net = make()
    trainer = Trainer(net, SGDMomentum(net, 0.01, 0.9), device=cuda)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32)).to(cuda)
    y = torch.from_numpy(np.eye(classes, dtype=np.float32)[[1, 2]]).to(cuda)
    for _ in range(3):  # adoption, warm-up and capture, a replay
        trainer.step(x, y)
    torch.cuda.synchronize()
    assert trainer.captures == 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss, _ = trainer.step(x, y)
        torch.cuda.synchronize()
    counts = dict.fromkeys(BN_TRAIN_KERNELS, 0)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            for name in BN_TRAIN_KERNELS:
                counts[name] += evt.count if name in evt.key else 0
    assert np.isfinite(float(loss)) and trainer.captures == 1
    assert counts == dict.fromkeys(BN_TRAIN_KERNELS, bns)


# the activation epilogue: the edge channels' beta (gamma 0), so that y is
# exactly -3, 0 and 3 there
BN_EDGES = (-3.0, 0.0, 3.0)


def _bn_act_inputs(device, C, dtype):
    g = torch.Generator(device=device).manual_seed(C + 7)
    shape = (4, 24, 24, C)
    x = (torch.randn(*shape, generator=g, device=device) * 1.5 + 0.25).to(dtype)
    gy = torch.randn(*shape, generator=g, device=device).to(dtype)
    gamma = 1.0 + 0.5 * torch.randn(C, generator=g, device=device)
    beta = 4.0 * torch.rand(C, generator=g, device=device) - 2.0
    if C >= 3:
        gamma[-3:] = 0.0
        beta[-3:] = torch.tensor(BN_EDGES, device=device)
    return x, gy, gamma, beta


@pytest.mark.parametrize("act", ["relu", "hswish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", BN_TRAIN_WIDTHS)
def test_bn_act_kernels_match_plain_and_the_unfused_chain(cuda, C, dtype, act):
    """With the activation epilogue, at 4 x 24 x 24 x C: act(y) and dx
    bit-equal to the plain versions, act(y) bit-equal to bn_apply then the
    activation's own op on the card; dbeta and dgamma within BN_SUM_RTOL of
    fp64 sums of the plain version's terms; two launches bit-equal; one
    bn_apply launch counted under its activation a call."""
    x, gy, gamma, beta = _bn_act_inputs(cuda, C, dtype)
    mean, var = batch_norm_stats(x)
    before = dict(bn_apply.launches_by_act)
    (out, norm), (out2, norm2) = (bn_apply(x, mean, var, gamma, beta, 1e-5, act)
                                  for _ in range(2))
    out_ref, norm_ref = bn_apply_plain(x, mean, var, gamma, beta, 1e-5, act)
    y, _ = bn_apply(x, mean, var, gamma, beta, 1e-5)
    unfused = torch.relu(y) if act == "relu" else y * hard_sigmoid(y)
    (dgamma, dbeta, coef), again = (bn_bwd_reduce(gy, x, norm, gamma, beta, act)
                                    for _ in range(2))
    dx, dx2 = (bn_bwd_dx(gy, x, norm, coef, gamma, beta, act) for _ in range(2))
    dx_ref = bn_bwd_dx_plain(gy, x, norm, coef, gamma, beta, act)
    M = x.numel() // C
    g64 = _dy(gy, x, norm, gamma, beta, act).double().reshape(M, C)
    t64 = g64 * ((x.float() - norm[0]) * norm[1]).to(dtype).double().reshape(M, C)
    torch.cuda.synchronize()
    assert bn_apply.launches_by_act["none"] == before["none"] + 1
    assert bn_apply.launches_by_act[act] == before[act] + 2
    assert out.dtype == dx.dtype == dtype
    assert torch.equal(out, out_ref) and torch.equal(out, unfused) and torch.equal(norm, norm_ref)
    assert torch.equal(dx, dx_ref) and torch.equal(out, out2) and torch.equal(dx, dx2)
    assert torch.equal(norm, norm2)
    assert all(torch.equal(a, b) for a, b in zip((dgamma, dbeta, coef), again, strict=True))
    assert ((dbeta.double() - g64.sum(0)).abs() <= BN_SUM_RTOL * g64.abs().sum(0)).all()
    assert ((dgamma.double() - t64.sum(0)).abs() <= BN_SUM_RTOL * t64.abs().sum(0)).all()


@pytest.mark.parametrize("act", ["relu", "hswish"])
def test_bn_act_gradients_match_the_unfused_chain_in_fp32(cuda, act):
    """fp32 on the card: _BNCore with the activation against _BNCore then
    the activation layer under autograd: the forward bit-equal, dx,
    dgamma and dbeta within 1e-5 of each one's largest magnitude."""
    x, gy, gamma, beta = _bn_act_inputs(cuda, 40, torch.float32)
    grads = []
    for fused in (True, False):
        xt, gt, bt = (t.clone().requires_grad_() for t in (x, gamma, beta))
        if fused:
            out, _, _ = norm_ops._BNCore.apply(xt, gt, bt, 1e-5, act)
        else:
            y, _, _ = norm_ops._BNCore.apply(xt, gt, bt, 1e-5)
            out = torch.relu(y) if act == "relu" else y * hard_sigmoid(y)
        grads.append((out.detach(),) + torch.autograd.grad(out, (xt, gt, bt), gy))
    torch.cuda.synchronize()
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1:], grads[1][1:], strict=True):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-7


@pytest.mark.parametrize("make,classes,by_act", [
    (lambda: ResNet18("dogs", num_classes=120), 120, dict(none=24, relu=10, hswish=0)),
    (lambda: MobileNetV3Large("mnv3l", num_classes=1000), 1000,
     dict(none=15, relu=11, hswish=20)),
], ids=["resnet18dw", "mnv3l"])
def test_eager_step_fuses_each_bn_activation_pair(cuda, make, classes, by_act):
    """An eager Trainer.step (2 images of 64 px) after the adoption step:
    bn_apply's launches by activation."""
    np.random.seed(0)
    net = make()
    trainer = Trainer(net, SGDMomentum(net, 0.01, 0.9), device=cuda, cuda_graph=False)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32)).to(cuda)
    y = torch.from_numpy(np.eye(classes, dtype=np.float32)[[1, 2]]).to(cuda)
    trainer.step(x, y)
    before = dict(bn_apply.launches_by_act)
    loss, _ = trainer.step(x, y)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert {k: bn_apply.launches_by_act[k] - before[k] for k in before} == by_act


# the bias pass: MobileNet-V3-Large's served output shapes (chip_smoke.V3L_BIAS)
# and odd C, the batch axis left out
BIAS_SHAPES = sorted({shape for shape, _, _ in chip_smoke.V3L_BIAS}) + [
    (5, 5, 1), (3, 7, 13), (9, 3), (1001,), (4, 4, 12)]
# values of y + b placed in the first rows, -0.0 in channel 0
BIAS_EDGES = (-0.0, float("nan"), -3.0, 0.0, 3.0, 6.0)


def _bias_inputs(device, shape, dtype):
    """y (8, *shape) and b, b in eighths with b[0] = -0.0, so that y + b is
    exactly each of BIAS_EDGES in channel r mod C of row r."""
    g = torch.Generator(device=device).manual_seed(sum(shape))
    C = shape[-1]
    b = torch.round(torch.randn(C, generator=g, device=device) * 24.0) / 8.0
    b[0] = -0.0
    y = torch.randn((8,) + shape, generator=g, device=device) * 3.0
    flat = y.view(-1, C)
    for r, e in enumerate(BIAS_EDGES):
        c = r % C
        flat[r, c] = e if c == 0 or e != e else e - b[c]
    return y.to(dtype), b


def _bits_equal(a, b):
    """Bit-equal where not NaN (-0.0 included), NaN in the same places."""
    nan = torch.isnan(a)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(ints), b[~nan].view(ints)))


@pytest.mark.parametrize("act", ["none", "relu", "hswish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BIAS_SHAPES)
def test_bias_act_kernel_matches_plain_on_both_routes(cuda, shape, dtype, act):
    """At batch 8: the kernel bit-equal to the plain version (the eager add
    and activation on the card), on the vector route where C takes one and
    on the scalar route (a misaligned copy of y); one launch counted under
    its act a call."""
    y, b = _bias_inputs(cuda, shape, dtype)
    want = bias_act_plain(y, b, act)
    buf = torch.empty(y.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % 16 != 0
    before = dict(bias_act.launches_by_act)
    with torch.no_grad():
        got, got_scalar = bias_act(y, b, act), bias_act(shifted, b, act)
    torch.cuda.synchronize()
    for out in (got, got_scalar):
        differ = (out.view(-1) != want.view(-1)) | (torch.signbit(out) != torch.signbit(want)).view(-1)
        differ &= ~(torch.isnan(out) & torch.isnan(want)).view(-1)
        first = differ.nonzero()[:3].flatten().tolist()
        assert _bits_equal(out, want), (first, y.view(-1)[first].tolist(),
                                        out.view(-1)[first].tolist(), want.view(-1)[first].tolist())
    assert {k: bias_act.launches_by_act[k] - before[k] for k in before} == dict(
        dict.fromkeys(before, 0), **{act: 2})


def test_bias_act_kernel_refuses_what_it_does_not_take(cuda):
    y, b = _bias_inputs(cuda, (4, 4, 8), torch.float32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            bias_act(y.transpose(1, 2), b, "relu")
        with pytest.raises(ValueError, match="b must be float32"):
            bias_act(y, b.cpu(), "relu")
        assert bias_act(y[:0], b, "hswish").shape == (0, 4, 4, 8)


def test_folded_v3_large_pairs_each_biased_layer_on_card(cuda, monkeypatch):
    """A BN-folded MobileNet-V3-Large (64 px, batch 2) served on the card:
    48 bias passes a dispatch (none 16, relu 11, hswish 21), the probs
    bit-equal to its layers run one by one, no pairing."""
    from dorknet_tpu_torch.layers import sequence
    from dorknet_tpu_torch.network import InferenceRunner

    np.random.seed(0)
    net = MobileNetV3Large("mnv3l", num_classes=1000)
    seed_serving_weights(net, seed=0, calib_hw=(64, 64))
    X = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    runner = InferenceRunner(net, batch_size=2, device=cuda, fold_bn=True)
    before = dict(bias_act.launches_by_act)
    paired = runner.predict_probs(X)
    torch.cuda.synchronize()
    assert {k: bias_act.launches_by_act[k] - before[k] for k in before} == \
        chip_smoke.V3L.bias_want == {"none": 16, "relu": 11, "hswish": 21}
    monkeypatch.setattr(sequence, "BIASED", ())
    np.testing.assert_array_equal(runner.predict_probs(X), paired)


GEMM_CASES = [(64, 32, 48), (300, 512, 120), (8, 16, 128), (1, 1, 1), (129, 7, 130),
              (257, 64, 256), (64, 0, 8)]


def _gemm_inputs(device, M, K, N, dtype):
    g = torch.Generator(device=device).manual_seed(M * 7 + K * 3 + N)
    a = torch.randn(M, K, generator=g, device=device).to(dtype)
    b = torch.randn(K, N, generator=g, device=device).to(dtype)
    return a, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", GEMM_CASES)
def test_matmul_kernel_matches_plain(cuda, M, K, N, dtype):
    """Within 2e-5 of (|a| @ |b|) per element (fp32 sums over K in another
    order; bf16 products are exact in fp32), one launch, fp32 out."""
    a, b = _gemm_inputs(cuda, M, K, N, dtype)
    before = matmul.launches
    y = matmul(a, b)
    ref = matmul_plain(a, b)
    scale = matmul_plain(a.abs(), b.abs())
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (M, N)
    assert bool(((y - ref).abs() <= 2e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", GEMM_CASES)
def test_matmul_bn_stats_kernel_matches_plain_and_repeats(cuda, M, K, N, dtype, out_dtype):
    """y as test_matmul_kernel_matches_plain, plus one bf16 step (2^-7 of
    |y|) for bf16 y; the statistics within their limits of the plain
    version's, which are taken from the fp32 product; two runs bit-equal."""
    a, b = _gemm_inputs(cuda, M, K, N, dtype)
    before = matmul_bn_stats.launches
    y, mean, var = matmul_bn_stats(a, b, out_dtype=out_dtype)
    y2, mean2, var2 = matmul_bn_stats(a, b, out_dtype=out_dtype)
    ref, ref_mean, ref_var = matmul_bn_stats_plain(a, b, out_dtype)
    limit = 2e-5 * matmul_plain(a.abs(), b.abs()) + 1e-6
    if out_dtype == torch.bfloat16:
        limit = limit + 2 ** -7 * ref.float().abs()
    torch.cuda.synchronize()
    assert matmul_bn_stats.launches == before + 2
    assert y.dtype == out_dtype and y.shape == (M, N) and mean.shape == var.shape == (N,)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)
    assert bool(((y.float() - ref.float()).abs() <= limit).all())
    assert _within_stats_limit(mean, var, ref_mean, ref_var)


def test_matmul_kernels_refuse_what_they_do_not_take(cuda):
    """The port's (O, C) pointwise weight is not b: its transpose view is
    refused, not copied; mixed types and devices are refused."""
    a = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(16, 8, device=cuda)
    before = (matmul.launches, matmul_bn_stats.launches)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a, w.t())
    with pytest.raises(ValueError, match="contiguous"):
        matmul_bn_stats(a, w.t())
    with pytest.raises(TypeError, match="or both bfloat16"):
        matmul(a, w.t().contiguous().bfloat16())
    with pytest.raises(ValueError, match="on"):
        matmul(a, w.t().contiguous().cpu())
    assert (matmul.launches, matmul_bn_stats.launches) == before
    assert matmul(a, w.t().contiguous()).shape == (4, 16)


def test_accumulate_step_on_card_matches_cpu(cuda):
    """ResNet18 at full width, fresh BN, one eager accumulate_step of K = 2
    micro-batches of 2 at 65 px on the card and on the CPU: the mean loss
    within 1e-4 relative (computed before the update, from the same
    weights); the BN pre-pass and the two micro-batches launch
    batch_norm_stats 34 x 3 times, the depthwise forward 48 and dx and dw 32
    each."""
    np.random.seed(0)
    net_cpu = ResNet18("dogs", num_classes=120)
    np.random.seed(0)
    net_gpu = ResNet18("dogs", num_classes=120)
    t_cpu = Trainer(net_cpu, SGDMomentum(net_cpu, 0.001, 0.9), device="cpu")
    t_gpu = Trainer(net_gpu, SGDMomentum(net_gpu, 0.001, 0.9), device=cuda, cuda_graph=False)
    rng = np.random.RandomState(5)
    X = rng.randn(2, 2, 3, 65, 65).astype(np.float32)
    y = np.eye(120, dtype=np.float32)[rng.randint(0, 120, (2, 2))]
    want = t_cpu.accumulate_step(X, y)
    kernels = (depthwise3x3, depthwise3x3_dx, depthwise3x3_dw, batch_norm_stats)
    counts = [k.launches for k in kernels]
    got = t_gpu.accumulate_step(X, y)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [48, 32, 32, 102]
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


# the tensor-core GEMM route: small A/B-like shapes (M a few tiles, K = 64
# and 1024, N = 256), the JAX package's shapes, ragged M (300, 8, 129) and K
# below or not a multiple of 64 (16, 32, 72)
TC_GEMM_CASES = [(1024, 64, 256), (384, 1024, 256), (64, 32, 48), (300, 512, 120),
                 (8, 16, 128), (300, 72, 64), (129, 16, 136), (8, 32, 8)]


def _tc_limit(a, b):
    """The tensor-core route's limit per element of y: GEMM_RTOL (2e-5) of
    |a| @ |b|, or twice the ratio cuBLAS's bf16 GEMM with fp32 output
    reaches on the same inputs, whichever is larger (the tensor cores add
    their products in their own order and rounding)."""
    scale = matmul_plain(a.abs(), b.abs())
    ref = matmul_plain(a, b)
    cublas = torch.mm(a, b, out_dtype=torch.float32)
    ratio = float(((cublas - ref).abs() / (2e-5 * scale + 1e-6)).max())
    return max(1.0, 2.0 * ratio) * (2e-5 * scale + 1e-6)


@pytest.mark.parametrize("M,K,N", TC_GEMM_CASES)
def test_tensor_core_matmul_matches_plain(cuda, M, K, N):
    """bf16 inputs with K, N multiples of 8 take the tensor-core route; fp32
    y within the route's limit of the plain version; two runs bit-equal."""
    a, b = _gemm_inputs(cuda, M, K, N, torch.bfloat16)
    assert _gemm_route(a, b) == "tensor_core"
    before = dict(matmul.launches_by_route)
    y = matmul(a, b)
    y2 = matmul(a, b)
    ref = matmul_plain(a, b)
    limit = _tc_limit(a, b)
    torch.cuda.synchronize()
    assert matmul.launches_by_route["tensor_core"] == before["tensor_core"] + 2
    assert matmul.launches_by_route["cuda_core"] == before["cuda_core"]
    assert y.dtype == torch.float32 and y.shape == (M, N)
    assert torch.equal(y, y2)
    assert bool(((y - ref).abs() <= limit).all())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", TC_GEMM_CASES)
def test_tensor_core_matmul_bn_stats_matches_plain(cuda, M, K, N, out_dtype):
    """The statistics epilogue on the tensor-core route: y within the route's
    limit (plus one bf16 step for bf16 y), the statistics within their
    limits of the plain version's; two runs bit-equal."""
    a, b = _gemm_inputs(cuda, M, K, N, torch.bfloat16)
    before = matmul_bn_stats.launches_by_route["tensor_core"]
    y, mean, var = matmul_bn_stats(a, b, out_dtype=out_dtype)
    y2, mean2, var2 = matmul_bn_stats(a, b, out_dtype=out_dtype)
    ref, ref_mean, ref_var = matmul_bn_stats_plain(a, b, out_dtype)
    limit = _tc_limit(a, b)
    if out_dtype == torch.bfloat16:
        limit = limit + 2 ** -7 * ref.float().abs()
    torch.cuda.synchronize()
    assert matmul_bn_stats.launches_by_route["tensor_core"] == before + 2
    assert y.dtype == out_dtype and y.shape == (M, N)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)
    assert bool(((y.float() - ref.float()).abs() <= limit).all())
    assert _within_stats_limit(mean, var, ref_mean, ref_var)


def test_tensor_core_route_agrees_with_the_cuda_core_route(cuda):
    """The two routes on the same bf16 inputs, one launch each."""
    a, b = _gemm_inputs(cuda, 300, 512, 120, torch.bfloat16)
    before = dict(matmul.launches_by_route)
    y_tc = launch_matmul(a, b, "tensor_core")
    y_cc = launch_matmul(a, b, "cuda_core")
    limit = _tc_limit(a, b)
    torch.cuda.synchronize()
    assert {k: matmul.launches_by_route[k] - before[k] for k in before} == \
        {"tensor_core": 1, "cuda_core": 1, "cuda_core_pipelined": 0}
    assert bool(((y_tc - y_cc).abs() <= 2 * limit).all())


def test_bf16_gemm_with_ragged_n_stays_on_the_cuda_cores(cuda):
    """N = 50 (not a multiple of 8): TMA cannot read b's rows, so the
    CUDA-core kernel runs, and agrees with the plain version."""
    a, b = _gemm_inputs(cuda, 64, 32, 50, torch.bfloat16)
    before = dict(matmul.launches_by_route)
    y = matmul(a, b)
    ref = matmul_plain(a, b)
    scale = matmul_plain(a.abs(), b.abs())
    torch.cuda.synchronize()
    assert matmul.launches_by_route["cuda_core"] == before["cuda_core"] + 1
    assert matmul.launches_by_route["tensor_core"] == before["tensor_core"]
    assert bool(((y - ref).abs() <= 2e-5 * scale + 1e-6).all())


def test_gemm_entry_point_refuses_what_the_tensor_cores_cannot_take(cuda):
    """Asked for the tensor-core route, the C side refuses fp32 inputs, K or
    N not a multiple of 8 and a misaligned view, and nothing launches."""
    before = dict(matmul.launches_by_route)
    bad = [
        _gemm_inputs(cuda, 16, 16, 16, torch.float32),
        _gemm_inputs(cuda, 16, 12, 16, torch.bfloat16),
        _gemm_inputs(cuda, 16, 16, 12, torch.bfloat16),
    ]
    a, b = bad[0]
    a_off = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(16, 16)
    bad.append((a_off, b.bfloat16()))  # a contiguous view 2 bytes off
    for a, b in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_matmul(a, b, "tensor_core")
    assert matmul.launches_by_route == before


# the vector depthwise route: C in {8, 24, 64}, W (and Wo) not a multiple of
# the strip width
DW_VEC_CASES = [(2, 9, 9, 24, 1), (2, 9, 9, 24, 2), (3, 13, 11, 64, 1), (3, 13, 11, 64, 2),
                (2, 10, 7, 8, 2), (4, 16, 19, 8, 1), (1, 1, 1, 8, 1), (2, 2, 3, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", DW_VEC_CASES)
def test_vector_depthwise_matches_scalar_and_plain(cuda, N, H, W, C, stride, dtype):
    """Every strip width of the vector route is bit-equal to the scalar
    route (same fmaf per tap, same order), and within the forward's limits
    of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(N * 1000 + H * 10 + C + stride)
    x = torch.randn(N, H, W, C, generator=g, device=cuda).to(dtype)
    w = torch.randn(C, 3, 3, generator=g, device=cuda).to(dtype).float()
    assert _dw_route(x) == "vector"
    before = dict(depthwise3x3.launches_by_route)
    y = depthwise3x3(x, w, stride)
    ys = launch_forward(x, w, stride, "scalar")
    strips = [launch_forward(x, w, stride, "vector", tw) for tw in (1, 2, 4, 8)]
    ref = depthwise3x3_plain(x, w, stride)
    torch.cuda.synchronize()
    assert depthwise3x3.launches_by_route["vector"] == before["vector"] + 5
    assert depthwise3x3.launches_by_route["scalar"] == before["scalar"] + 1
    assert all(torch.equal(v, ys) for v in [y] + strips)
    tol = 1e-5 * float(ref.float().abs().max()) + 1e-6 if dtype == torch.float32 else 0.0
    assert float((y.float() - ref.float()).abs().max()) <= tol


def test_depthwise_entry_point_refuses_what_the_vector_route_cannot_take(cuda):
    """C = 6, a misaligned view and a strip of 3 are refused by the C side
    on the vector route; the scalar route takes C = 6."""
    w = torch.randn(6, 3, 3, device=cuda)
    x = torch.randn(1, 4, 4, 6, device=cuda)
    before = dict(depthwise3x3.launches_by_route)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch_forward(x, w, 1, "vector")
    x8 = torch.randn(1 * 4 * 4 * 8 + 1, device=cuda)[1:].view(1, 4, 4, 8)
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch_forward(x8, torch.randn(8, 3, 3, device=cuda), 1, "vector")
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch_forward(torch.randn(1, 4, 4, 8, device=cuda), torch.randn(8, 3, 3, device=cuda),
                       1, "vector", tw=3)
    assert depthwise3x3.launches_by_route == before
    assert _dw_route(x) == "scalar"
    assert torch.equal(depthwise3x3(x, w, 1), launch_forward(x, w, 1, "scalar"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", DW_VEC_CASES)
def test_vector_dx_matches_scalar_and_plain(cuda, N, H, W, C, stride, dtype):
    """dx's vector route at every strip width is bit-equal to its scalar
    route (same fmaf per tap, same order), and within dx's limits of the
    plain version."""
    _, g, w = _bwd_inputs(cuda, N, H, W, C, stride, dtype)
    assert _dx_route(g) == "vector"
    before = dict(depthwise3x3_dx.launches_by_route)
    dx = depthwise3x3_dx(g, w, stride, H, W)
    dxs = launch_dx(g, w, stride, H, W, "scalar")
    strips = [launch_dx(g, w, stride, H, W, "vector", tw) for tw in (1, 2, 4, 8)]
    ref = depthwise3x3_dx_plain(g, w, stride, H, W)
    torch.cuda.synchronize()
    assert depthwise3x3_dx.launches_by_route == {"scalar": before["scalar"] + 1,
                                                 "vector": before["vector"] + 5}
    assert all(torch.equal(v, dxs) for v in [dx] + strips)
    tol = 1e-5 * float(ref.float().abs().max()) + 1e-6 if dtype == torch.float32 else 0.0
    assert float((dx.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C,stride", DW_VEC_CASES + [(2, 9, 9, 12, 2)])
def test_vector_dw_matches_plain_and_repeats(cuda, N, H, W, C, stride, dtype):
    """dw's vector route within 2e-5 of sum|x*g| per tap and channel of the
    plain version (fp32 sums in another order), twice bit-equal; the scalar
    route on the same inputs too."""
    x, g, _ = _bwd_inputs(cuda, N, H, W, C, stride, dtype)
    assert _dwgrad_route(x, g) == "vector"
    before = dict(depthwise3x3_dw.launches_by_route)
    dw = depthwise3x3_dw(x, g, stride)
    again = launch_dw(x, g, stride, "vector")
    dws = launch_dw(x, g, stride, "scalar")
    ref = depthwise3x3_dw_plain(x, g, stride)
    limit = 2e-5 * depthwise3x3_dw_plain(x.float().abs(), g.float().abs(), stride) + 1e-6
    torch.cuda.synchronize()
    assert depthwise3x3_dw.launches_by_route == {"scalar": before["scalar"] + 1,
                                                 "vector": before["vector"] + 2}
    assert torch.equal(dw, again)
    for got in (dw, dws):
        assert got.dtype == torch.float32 and got.shape == (C, 3, 3)
        assert bool(((got - ref).abs() <= limit).all())


def test_gradient_entry_points_refuse_what_the_vector_routes_cannot_take(cuda):
    """Asked for the vector route, the C side refuses C = 6, misaligned
    views and a strip of 3 for dx, and C = 6 and misaligned views for dw;
    nothing launches. The scalar routes take them all."""
    before = [dict(k.launches_by_route) for k in (depthwise3x3_dx, depthwise3x3_dw)]
    x6, g6, w6 = _bwd_inputs(cuda, 1, 4, 4, 6, 1, torch.float32)
    x8, g8, w8 = _bwd_inputs(cuda, 1, 4, 4, 8, 1, torch.bfloat16)
    # contiguous views 8 and 4 bytes into their storage, with g8's and x8's values
    g_off = torch.zeros(g8.numel() + 4, dtype=g8.dtype, device=cuda)[4:].view(g8.shape)
    x_off = torch.zeros(x8.numel() + 2, dtype=x8.dtype, device=cuda)[2:].view(x8.shape)
    g_off.copy_(g8)
    x_off.copy_(x8)
    for g, w, tw in ((g6, w6, None), (g_off, w8, None), (g8, w8, 3)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_dx(g, w, 1, 4, 4, "vector", tw)
    g_odd = torch.zeros(g8.numel() + 1, dtype=g8.dtype, device=cuda)[1:].view(g8.shape)
    for x, g in ((x6, g6), (x_off, g8), (x8, g_odd)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_dw(x, g, 1, "vector")
    assert [dict(k.launches_by_route) for k in (depthwise3x3_dx, depthwise3x3_dw)] == before
    assert _dx_route(g_off) == "scalar" and _dwgrad_route(x_off, g8) == "scalar"
    assert torch.equal(depthwise3x3_dx(g_off, w8, 1, 4, 4), launch_dx(g8, w8, 1, 4, 4, "scalar"))
    assert torch.equal(depthwise3x3_dw(x6, g6, 1), launch_dw(x6, g6, 1, "scalar"))


# the pipelined fp32 route: GEMM_CASES, the flagship's pointwise shapes and
# dense head with M cut to a few tiles (ragged), and larger grids; every case
# in each of the route's three tiles
PIPELINED_CASES = [c for c in GEMM_CASES if c[1] % 4 == 0 and c[2] % 4 == 0 and c[1]] + \
    [(3 * 128 + 17, K, N) for K, N in ((64, 64), (64, 128), (128, 128), (128, 256),
                                       (256, 256), (256, 512), (512, 512))] + \
    [(64, 512, 120), (33900, 64, 128), (40000, 64, 64), (300, 256, 512)]


@pytest.mark.parametrize("M,K,N", PIPELINED_CASES)
def test_pipelined_route_is_bit_equal_to_the_cuda_core_route(cuda, M, K, N):
    """fp32 y of "cuda_core_pipelined", in its default tile and in each of
    its two, torch.equal to "cuda_core"'s (each element one fmaf chain
    over k in order, whatever the tile); with the statistics epilogue, y
    bit-equal too in fp32 and bf16, the statistics within their limits of
    the plain version and bit-equal on repeat."""
    a, b = _gemm_inputs(cuda, M, K, N, torch.float32)
    assert _gemm_route(a, b) == "cuda_core_pipelined"
    before = dict(matmul.launches_by_route)
    y = matmul(a, b)
    y_old = launch_matmul(a, b, "cuda_core")
    torch.cuda.synchronize()
    assert {k: matmul.launches_by_route[k] - before[k] for k in before} == \
        {"cuda_core_pipelined": 1, "cuda_core": 1, "tensor_core": 0}
    assert torch.equal(y, y_old)
    for tile in PIPELINED_TILES:
        assert torch.equal(launch_matmul(a, b, "cuda_core_pipelined", tile), y_old)
    for out_dtype in (torch.float32, torch.bfloat16):
        yo, _, _ = launch_matmul_bn_stats(a, b, out_dtype, "cuda_core")
        _, ref_mean, ref_var = matmul_bn_stats_plain(a, b, out_dtype)
        for tile in (None,) + PIPELINED_TILES:
            ys, mean, var = launch_matmul_bn_stats(a, b, out_dtype, "cuda_core_pipelined", tile)
            ys2, mean2, var2 = launch_matmul_bn_stats(a, b, out_dtype, "cuda_core_pipelined",
                                                      tile)
            torch.cuda.synchronize()
            assert torch.equal(ys, yo) and torch.equal(ys, ys2)
            assert torch.equal(mean, mean2) and torch.equal(var, var2)
            assert _within_stats_limit(mean, var, ref_mean, ref_var)
    assert _gemm_tile(M, K, N) in PIPELINED_TILES


def test_gemm_entry_point_refuses_what_the_pipelined_route_cannot_take(cuda):
    """Asked for the pipelined route, the C side refuses bf16 inputs, K or N
    not a multiple of 4, no K and a misaligned view, and nothing launches."""
    before = dict(matmul.launches_by_route)
    bad = [
        _gemm_inputs(cuda, 16, 16, 16, torch.bfloat16),
        _gemm_inputs(cuda, 16, 6, 16, torch.float32),
        _gemm_inputs(cuda, 16, 16, 6, torch.float32),
        _gemm_inputs(cuda, 16, 0, 16, torch.float32),
    ]
    a_off = torch.zeros(16 * 16 + 1, device=cuda)[1:].view(16, 16)
    bad.append((a_off, _gemm_inputs(cuda, 16, 16, 16, torch.float32)[1]))
    for a, b in bad:
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch_matmul(a, b, "cuda_core_pipelined")
    assert matmul.launches_by_route == before


# ---------------------------------------------------------------------- #
# Captured steps: Trainer's CUDA graphs against its eager steps
# ---------------------------------------------------------------------- #
def _graph_net(seed):
    """Stem conv, BN, ReLU, one residual block (a stride-2 depthwise, a
    pointwise and a skip projection, every batch norm), GAP, dense to 5
    classes: every kernel of the training step at a small size."""
    from dorknet_tpu_torch import layers as L
    from dorknet_tpu_torch.network import FeedForwardNetwork

    np.random.seed(seed)
    net = FeedForwardNetwork("graph")
    net.add_layer(L.ConvLayer("conv0", filter_block_shape=(8, 3, 3, 3), stride=2, padding=1,
                              with_bias=False))
    net.add_layer(L.BatchNormLayer("conv0_bn", incoming_chans=8))
    net.add_layer(L.ReLu("conv0_relu"))
    net.add_layer(L.ResidualBlock("res", layer_list=[
        L.DepthwiseConvLayer("res_dw", filter_block_shape=(8, 3, 3), stride=2, with_bias=False),
        L.BatchNormLayer("res_dw_bn", incoming_chans=8),
        L.PointwiseConvLayer("res_pw", filter_block_shape=(16, 8), with_bias=False),
        L.BatchNormLayer("res_pw_bn", incoming_chans=16)],
        skip_projection=L.PointwiseConvLayer("res_skip", filter_block_shape=(16, 8), stride=2,
                                             with_bias=False),
        post_skip_activation=L.ReLu("res_relu")))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense", incoming_chans=16, output_dim=5))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("loss"))
    return net


def _graph_pair(cuda, **kwargs):
    """A captured and an eager trainer from the same weights."""
    return [Trainer(net, SGDMomentum(net, 0.05, 0.9), device=cuda, ema_decay=0.9,
                    clip_norm=1.0, cuda_graph=flag, **kwargs)
            for net, flag in ((_graph_net(70), True), (_graph_net(70), False))]


def _assert_same_training(a, b):
    """Parameters, running stats and EMA of two trainers, within the
    training slice's tolerance (1e-4 relative, 1e-5 absolute; bit-equal
    unless cuBLAS picks another algorithm under capture)."""
    def stats(t):
        return [b for m in t.network.modules() if hasattr(m, "running_std")
                for b in (m.running_mean, m.running_std)]

    pairs = (list(zip(a.network.parameters(), b.network.parameters(), strict=True))
             + list(zip(stats(a), stats(b), strict=True))
             + list(zip(a._ema, b._ema, strict=True)))
    for x, y in pairs:
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def _graph_batches(seed, steps, B=4, hw=17, classes=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(steps, B, 3, hw, hw).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, (steps, B))]
    return X, y


def test_captured_step_and_multi_step_equal_eager_steps(cuda):
    """Five steps from fresh batch norms: the first adopts (eager), the
    second warms up and captures, the rest replay; host arrays and device
    tensors as inputs; then a multi_step of three replays."""
    graphed, eager = _graph_pair(cuda)
    X, y = _graph_batches(71, 8)
    for k in range(5):
        Xk, yk = (X[k], y[k]) if k % 2 else (torch.from_numpy(X[k]).to(cuda),
                                               torch.from_numpy(y[k]).to(cuda))
        lg, pg = graphed.step(Xk, yk)
        le, pe = eager.step(Xk, yk)
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
        assert torch.equal(pg, pe)
    assert graphed.captures == 1 and eager.captures == 0
    lg, pg = graphed.multi_step(X[5:], y[5:])
    le, pe = eager.multi_step(X[5:], y[5:])
    torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
    assert graphed.captures == 1
    _assert_same_training(graphed, eager)


def test_replayed_outputs_are_copies(cuda):
    graphed, _ = _graph_pair(cuda)
    X, y = _graph_batches(72, 4)
    out = [graphed.step(X[k], y[k]) for k in range(4)]
    torch.cuda.synchronize()
    losses = [float(loss) for loss, _ in out]
    assert len(set(losses)) == 4 and graphed.captures == 1


def test_captured_accumulate_step_equals_eager(cuda):
    graphed, eager = _graph_pair(cuda)
    X, y = _graph_batches(73, 8)
    for call in range(4):
        sl = slice(2 * call, 2 * call + 2)
        lg, le = graphed.accumulate_step(X[sl], y[sl]), eager.accumulate_step(X[sl], y[sl])
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
    assert graphed.captures == 1
    _assert_same_training(graphed, eager)


@pytest.mark.parametrize("indexed", [False, True], ids=["direct", "indexed"])
def test_captured_augmented_steps_draw_as_eager_steps(cuda, indexed):
    """K replayed augmented steps from generator seed s draw what K eager
    steps from seed s draw (the graph advances the caller's generator), with
    mixup; then the multi-step form."""
    graphed, eager = _graph_pair(cuda)
    aug = dict(AUG_CFG, mixup=(0.0, 0.3))
    images = _precrop_batch(cuda, 24, 24, 24, 74)
    labels = torch.from_numpy(np.random.RandomState(75).randint(0, 5, 24)).int().to(cuda)
    rows = np.random.RandomState(76).randint(0, 24, (8, 4))
    losses = []
    for t in (graphed, eager):
        gen = torch.Generator(device=cuda).manual_seed(77)
        out = []
        for k in range(5):
            if indexed:
                out.append(t.step_augmented_indexed(gen, images, labels, rows[k], (17, 17), 5,
                                                    **aug)[0])
            else:
                Xk = images[torch.from_numpy(rows[k]).to(cuda)]
                yk = torch.nn.functional.one_hot(labels[torch.from_numpy(rows[k]).to(cuda)]
                                                 .long(), 5).float()
                out.append(t.step_augmented(gen, Xk, yk, (17, 17), **aug)[0])
        if indexed:
            out.extend(t.multi_step_augmented_indexed(gen, images, labels, rows[5:], (17, 17), 5,
                                                      **aug)[0])
        else:
            Xs = images[torch.from_numpy(rows[5:]).to(cuda)]
            ys = torch.nn.functional.one_hot(labels[torch.from_numpy(rows[5:]).to(cuda)]
                                             .long(), 5).float()
            out.extend(t.multi_step_augmented(gen, Xs, ys, (17, 17), **aug)[0])
        losses.append(torch.stack(out))
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0)
    assert graphed.captures == 1
    _assert_same_training(graphed, eager)


def test_schedule_change_reaches_the_replay_without_recapture(cuda):
    from dorknet_tpu_torch.utils.schedules import StepDecay

    graphed, eager = _graph_pair(cuda)
    X, y = _graph_batches(78, 6)
    schedule = StepDecay(0.05, (3, 4), 0.1)
    for k in range(6):
        for t in (graphed, eager):
            schedule.apply(t.optimiser, k)
            t.step(X[k], y[k])
    assert graphed.captures == 1
    _assert_same_training(graphed, eager)


def test_hyper_change_captures_a_new_graph(cuda):
    graphed, eager = _graph_pair(cuda)
    X, y = _graph_batches(79, 6)
    for k in range(6):
        if k == 3:
            graphed.optimiser.momentum = eager.optimiser.momentum = 0.5
        graphed.step(X[k], y[k])
        eager.step(X[k], y[k])
    assert graphed.captures == 2
    _assert_same_training(graphed, eager)


def test_remat_steps_capture_and_equal_eager(cuda):
    for remat in (True, "blocks"):
        graphed, eager = _graph_pair(cuda, remat=remat)
        X, y = _graph_batches(80, 4)
        for k in range(4):
            torch.testing.assert_close(graphed.step(X[k], y[k])[0], eager.step(X[k], y[k])[0],
                                       rtol=1e-5, atol=0)
        assert graphed.captures == 1
        _assert_same_training(graphed, eager)


def test_a_capture_that_fails_raises(cuda):
    """A layer that waits on the card in train mode cannot be captured: the
    capture raises after its warm-up step, and the next call raises without
    taking a step; no step quietly runs eagerly in its place."""
    from dorknet_tpu_torch.layers.base import Layer

    class Waits(Layer):
        def fapply(self, x, train=False):
            if train:
                float(x.detach().sum())
            return x

    graphed, _ = _graph_pair(cuda)
    graphed.network.layers.insert(3, Waits("waits"))
    X, y = _graph_batches(81, 3)
    graphed.step(X[0], y[0])  # fresh batch norms: eager
    with pytest.raises(RuntimeError, match="warm-up step was applied"):
        graphed.step(X[1], y[1])
    torch.cuda.synchronize()
    after_warm_up = [p.detach().clone() for p in graphed.network.parameters()]
    with pytest.raises(RuntimeError, match="no step was taken"):
        graphed.step(X[2], y[2])
    torch.cuda.synchronize()
    for p, q in zip(graphed.network.parameters(), after_warm_up, strict=True):
        assert torch.equal(p, q)
    assert graphed.captures == 0


def test_captured_step_opens_its_spans(cuda):
    """The profiler ranges of the captured path (``utils/tracing.span``),
    all on the host: the adopting step and the warm-up under
    ``trainer.eager``, the capture under ``trainer.capture``, and each
    replay's ``trainer.stage``, ``trainer.replay`` and ``trainer.outputs``,
    in that order, inside its ``trainer.step``; a pinned slot whose copy
    waits behind a spin kernel opens ``ring.wait``."""
    from dorknet_tpu_torch.data_loading.prefetch import PinnedRing

    graphed, _ = _graph_pair(cuda)
    X, y = _graph_batches(82, 4)
    ring = PinnedRing(1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(4):  # host arrays: a replay stages them through its pinned ring
            graphed.step(X[k], y[k])
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        ring.release(0, cuda)
        ring.acquire()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("dorknet.")]
    # host ranges only: none is copied onto the card's timeline
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events)
    ranges = sorted(((e.name()[len("dorknet."):], e.start_ns(), e.end_ns()) for e in events),
                    key=lambda r: r[1])
    names = [n for n, _, _ in ranges]
    assert names.count("trainer.step") == 4 and names.count("trainer.key") == 4
    assert names.count("trainer.eager") == 2 and names.count("trainer.capture") == 1
    steps = [r for r in ranges if r[0] == "trainer.step"]
    for step in steps[2:]:
        inside = [n for n, s, f in ranges if step[1] <= s and f <= step[2] and n != "trainer.step"]
        assert [n for n in inside if n != "ring.wait"] == [
            "trainer.key", "trainer.stage", "trainer.replay", "trainer.outputs"]
    assert names[-1] == "ring.wait" and graphed.captures == 1


def test_captured_convnext_replays_equal_eager_steps(cuda):
    """A small ConvNeXt (two stages of one block) under AdamW: the first
    step warms up and captures (no batch norm to adopt), the next three
    replay. Each equals an eager trainer's step, and both step counts read
    4 on the card: each replay advanced the count, where one baked into the
    graph would give every replay the first step's bias corrections."""
    from dorknet_tpu_torch.models import ConvNeXt
    from dorknet_tpu_torch.optimisers import AdamW

    trainers = []
    for flag in (True, False):
        np.random.seed(90)
        net = ConvNeXt("small", num_classes=5, depths=(1, 1), dims=(24, 48))
        trainers.append(Trainer(net, AdamW(net, 1e-3), device=cuda, cuda_graph=flag))
    graphed, eager = trainers
    X, y = _graph_batches(91, 4, hw=32)
    for k in range(4):
        lg, pg = graphed.step(X[k], y[k])
        le, pe = eager.step(X[k], y[k])
        torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
    assert graphed.captures == 1 and eager.captures == 0
    assert graphed._cache[-1].device.type == "cuda"
    assert float(graphed._cache[-1]) == float(eager._cache[-1]) == 4.0
    for a, b in zip(graphed.network.parameters(), eager.network.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 56, 56, 96), (128, 768)], ids=["nhwc", "rows"])
def test_layer_norm_on_card_matches_cpu(cuda, shape, dtype):
    """``ops.norm.layer_norm``'s values and the gradients of x, gamma and
    beta on the card against the CPU, at ConvNeXt-T's first NHWC shape (8
    images) and its head's rows. fp32: y and dx within 1e-5; dgamma and
    dbeta, sums over 25,088 rows of magnitude up to about 500, within 2e-3
    absolute (the CPU's own sums sit 3.7e-4 from fp64's at the NHWC shape).
    bf16 activations: within a bf16 step."""
    g = torch.Generator().manual_seed(shape[-1])
    C = shape[-1]
    leaves = (torch.randn(shape, generator=g).to(dtype), 1 + 0.1 * torch.randn(C, generator=g),
              0.1 * torch.randn(C, generator=g))
    dy = torch.randn(shape, generator=g).to(dtype)
    out = []
    for dev in (torch.device("cpu"), cuda):
        xs = [t.to(dev).requires_grad_() for t in leaves]
        y = norm_ops.layer_norm(*xs, eps=1e-6)
        grads = torch.autograd.grad(y, xs, dy.to(dev))
        out.append([t.float().cpu() for t in (y, *grads)])
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tols = [dict(rtol=1e-5, atol=1e-5)] * 2 + [dict(rtol=1e-5, atol=2e-3)] * 2
    else:
        tols = [dict(rtol=1e-2, atol=1e-2)] * 4
    for a, b, tol, what in zip(*out, tols, ("y", "dx", "dgamma", "dbeta"), strict=True):
        torch.testing.assert_close(b, a, **tol, msg=lambda m: "{}: {}".format(what, m))


# ConvNeXt-T's four 7x7 depthwise stages (H = W, C), and odd shapes
DW7_STAGES = [(56, 96), (28, 192), (14, 384), (7, 768)]


def _dw7_inputs(device, N, H, W, C, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((N, H, W, C), generator=g, device=device).to(dtype)
    gy = torch.randn((N, H, W, C), generator=g, device=device).to(dtype)
    return x, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,C", [(N, H, H, C) for (H, C), N in zip(DW7_STAGES, (8, 4, 2, 8))]
                         + [(3, 5, 9, 8), (2, 13, 11, 12), (1, 1, 1, 4), (2, 9, 20, 36)])
def test_dw7x7_kernel_matches_plain_and_repeats(cuda, N, H, W, C, dtype):
    """The 7x7 weight gradient on the card against the fp64 sum of the same
    (fp32 or bf16) inputs: within 1e-5 of the sum of the terms' magnitudes
    per tap (fp32 sums of up to 25,088 terms); two runs bit-equal; one
    launch a call."""
    x, gy = _dw7_inputs(cuda, N, H, W, C, dtype, N * 1000 + H + C)
    before = depthwise7x7_dw.launches_by_route["strip"]
    dw = depthwise7x7_dw(x, gy)
    again = depthwise7x7_dw(x, gy)
    torch.cuda.synchronize()
    assert depthwise7x7_dw.launches_by_route["strip"] == before + 2
    assert dw.dtype == torch.float32 and dw.shape == (C, 7, 7)
    assert torch.equal(dw, again)
    ref = depthwise7x7_dw_plain(x.double(), gy.double())
    mag = depthwise7x7_dw_plain(x.double().abs(), gy.double().abs())
    assert float(((dw.double() - ref).abs() / mag.clamp_min(1e-30)).max()) < 1e-5


def test_dw7x7_kernel_refuses_what_it_does_not_take(cuda):
    """C must be a multiple of 4, x and g one contiguous shape and dtype,
    float32 or bfloat16, aligned to 4 channels (the kernel copies 4 at a
    time): a view one element past an allocation is refused, one 4 channels
    past it is taken and gives the plain version's sums."""
    x, gy = _dw7_inputs(cuda, 2, 9, 9, 6, torch.float32, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        depthwise7x7_dw(x, gy)
    x, gy = _dw7_inputs(cuda, 2, 9, 9, 8, torch.float32, 2)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise7x7_dw(x.transpose(1, 2), gy)
    with pytest.raises(ValueError):
        depthwise7x7_dw(x, gy.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        depthwise7x7_dw(x.half(), gy.half())
    flat = torch.randn(4 + x.numel(), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        depthwise7x7_dw(flat[1:1 + x.numel()].view(x.shape), gy)
    with pytest.raises(ValueError, match="aligned"):
        depthwise7x7_dw(x, flat[2:2 + x.numel()].view(x.shape))
    xo = flat[4:].view(x.shape)  # 16 bytes past the allocation
    xo.copy_(x)
    torch.testing.assert_close(depthwise7x7_dw(xo, gy), depthwise7x7_dw_plain(x, gy),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("H,C", DW7_STAGES)
def test_dw7x7_forward_and_dx_equal_the_conv2d_path(cuda, H, C):
    """``Depthwise7x7Fn``'s forward and dx on the card are the values
    autograd gives through ``F.conv2d`` (the path every other depthwise
    shape takes), bit for bit; dw within 1e-5 relative of cuDNN's (TF32
    off)."""
    from dorknet_tpu_torch.ops.conv import _nhwc_conv

    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn((4, H, H, C), generator=g, device=cuda)
    w = torch.randn((C, 7, 7), generator=g, device=cuda) / 7
    gy = torch.randn((4, H, H, C), generator=g, device=cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        ya = _nhwc_conv(xa, wa.unsqueeze(1), 1, 3, groups=C)
        dxa, dwa = torch.autograd.grad(ya, (xa, wa), gy)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        yb = Depthwise7x7Fn.apply(xb, wb)
        dxb, dwb = torch.autograd.grad(yb, (xb, wb), gy)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert torch.equal(ya, yb) and torch.equal(dxa, dxb)
    assert float((dwa - dwb).norm() / dwa.norm()) < 1e-5


def test_captured_convnext_t_step_launches_the_7x7_dw_18_times(cuda):
    """One replay of a captured ConvNeXt-T step (published depths and
    widths, 2 images of 32 px), profiled: the 7x7 weight gradient's two
    kernels run 18 times each, once a depthwise layer, and cuDNN's grouped
    weight gradient not at all; the eager steps before the capture count 18
    wrapper launches a step."""
    from dorknet_tpu_torch.models import ConvNeXt
    from dorknet_tpu_torch.optimisers import AdamW

    np.random.seed(0)
    net = ConvNeXt("convnext_t", num_classes=10)
    trainer = Trainer(net, AdamW(net, 1e-3), device=cuda)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 32, 32).astype(np.float32)).to(cuda)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[[1, 2]]).to(cuda)
    before = depthwise7x7_dw.launches
    for _ in range(2):  # warm-up and capture, a replay
        trainer.step(x, y)
    torch.cuda.synchronize()
    assert trainer.captures == 1
    assert (depthwise7x7_dw.launches - before) % 18 == 0 and depthwise7x7_dw.launches > before
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss, _ = trainer.step(x, y)
        torch.cuda.synchronize()
    names = ("depthwise7x7_dw_partial_kernel", "depthwise7x7_dw_finish_kernel",
             "wgrad2d_grouped")
    counts = dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                counts[name] += evt.count if name in evt.key else 0
    assert np.isfinite(float(loss)) and trainer.captures == 1
    assert counts == {names[0]: 18, names[1]: 18, names[2]: 0}
