"""The port's CUDA kernels on the card. These tests skip without a CUDA
device; on the GPU machine (which has no jax, so the suite's conftest cannot
load there) run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch.data_loading.device_augment import (  # noqa: E402
    draw_batch_params, train_pipeline)
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import Trainer  # noqa: E402
from dorknet_tpu_torch.ops.cuda.augment import augment_planes_fused  # noqa: E402
from dorknet_tpu_torch.ops.cuda.depthwise import (  # noqa: E402
    depthwise3x3, depthwise3x3_dw, depthwise3x3_dw_plain, depthwise3x3_dx,
    depthwise3x3_dx_plain, depthwise3x3_plain)
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


def test_trainer_step_on_card_matches_cpu(cuda):
    """ResNet18 at full width, fresh BN, two Trainer.steps (clip 1.0, EMA
    0.9) at batch 4 at the flagship's 225 px on the card and on the CPU
    (fp32, TF32 off): per-step loss within 1e-4 relative, parameters within
    1e-4 relative / 1e-5 absolute, and every step launched the forward, dx
    and dw kernels 16 times each. Why this configuration: the fresh weights
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
    t_gpu = Trainer(net_gpu, SGDMomentum(net_gpu, 0.001, 0.9), device=cuda, **args)
    rng = np.random.RandomState(1)
    for _ in range(2):
        X = rng.randn(4, 3, 225, 225).astype(np.float32)
        y = np.eye(120, dtype=np.float32)[rng.randint(0, 120, 4)]
        want, _ = t_cpu.step(X, y)
        counts = (depthwise3x3.launches, depthwise3x3_dx.launches, depthwise3x3_dw.launches)
        got, _ = t_gpu.step(X, y)
        torch.cuda.synchronize()
        assert (depthwise3x3.launches, depthwise3x3_dx.launches,
                depthwise3x3_dw.launches) == tuple(n + 16 for n in counts)
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
    in the wrapper and through train_pipeline; a rotation whose two stage
    buffers exceed a block's shared memory raises with the size."""
    p = draw_batch_params(torch.Generator(device=cuda), 2, (30, 30), (24, 24), **AUG_CFG)
    xf = torch.zeros((2, 30, 30, 3), device=cuda)
    with pytest.raises(TypeError, match="uint8"):
        augment_planes_fused(xf, p, (24, 24), **AUG_CFG)
    with pytest.raises(TypeError, match="uint8"):
        train_pipeline(torch.Generator(device=cuda), xf, torch.zeros((2, 3), device=cuda),
                       (24, 24), **AUG_CFG)
    big = torch.zeros((1, 330, 330, 3), dtype=torch.uint8, device=cuda)
    pb = draw_batch_params(torch.Generator(device=cuda), 1, (330, 330), (320, 320), **AUG_CFG)
    before = augment_planes_fused.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        augment_planes_fused(big, pb, (320, 320), **AUG_CFG)
    assert augment_planes_fused.launches == before
