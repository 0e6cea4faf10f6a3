"""The port's CUDA kernels on the card. These tests skip without a CUDA
device; on the GPU machine (which has no jax, so the suite's conftest cannot
load there) run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.ops.cuda.depthwise import depthwise3x3, depthwise3x3_plain  # noqa: E402
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
    x = torch.randn(1, 5, 5, 4, device=cuda, requires_grad=True)
    w = torch.randn(4, 3, 3, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        depthwise3x3(x, w, 1)
    with torch.inference_mode():
        assert depthwise3x3(x, w, 1).shape == (1, 5, 5, 4)
    with pytest.raises(ValueError, match="x on"):
        depthwise3x3(x.detach(), w.cpu(), 1)


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
