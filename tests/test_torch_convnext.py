"""ConvNeXt's parts of the port on the CPU: ``LayerNormLayer``, ``GELU``,
``LayerScale``, ``AdamW`` and the ``ConvNeXt`` model. The JAX package has
none of them, so they are held to plain PyTorch: ``F.layer_norm``,
``F.gelu(approximate="none")`` and ``torch.optim.AdamW``.

- LayerNorm over NHWC and (N, C) inputs: values and the gradients of x,
  gamma and beta, in fp32 and with bf16 activations under the bf16 compute
  dtype; GELU; the layer scale's values and gradients.
- h5+json and ``utils/torch_io`` round trips of a small ConvNeXt, which
  holds every new layer.
- AdamW against ``torch.optim.AdamW`` over three steps, the decay on the
  weights only, the step count on the parameters' device, and a checkpoint
  after step 2 restored into a fresh trainer giving step 3 equal to an
  uninterrupted run's.
- ConvNeXt-T's size, layers and names: 28,589,128 parameters, 23
  LayerNorms, 18 blocks, every parameter named as the benchmark's plain
  reference names it.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from dorknet_tpu_torch import config  # noqa: E402
from dorknet_tpu_torch import layers as L  # noqa: E402
from dorknet_tpu_torch.models import ConvNeXt  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import AdamW  # noqa: E402
from dorknet_tpu_torch.optimisers.AdamW import decayed  # noqa: E402
from dorknet_tpu_torch.utils import torch_io  # noqa: E402

SMALL = dict(num_classes=5, depths=(1, 1), dims=(8, 16))


@pytest.fixture
def bf16():
    config.set_compute_dtype(torch.bfloat16)
    yield
    config.set_compute_dtype(torch.float32)


def _leaves(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    x = torch.randn(shape, generator=g).to(dtype).requires_grad_()
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).requires_grad_()
    beta = (0.1 * torch.randn(C, generator=g)).requires_grad_()
    return x, gamma, beta, torch.randn(shape, generator=g).to(dtype)


def _small(seed=5):
    np.random.seed(seed)
    return ConvNeXt("small", **SMALL)


def _batches(seed, steps=3, B=4, hw=32):
    rng = np.random.RandomState(seed)
    X = rng.randn(steps, B, 3, hw, hw).astype(np.float32)
    y = np.eye(SMALL["num_classes"], dtype=np.float32)[rng.randint(0, SMALL["num_classes"],
                                                                   (steps, B))]
    return X, y


@pytest.mark.parametrize("shape", [(2, 5, 7, 12), (6, 20)], ids=["nhwc", "rows"])
def test_layer_norm_matches_f_layer_norm(shape):
    x, gamma, beta, dy = _leaves(shape, 1)
    layer = L.LayerNormLayer("ln", shape[-1], eps=1e-6)
    with torch.no_grad():
        layer.gamma.copy_(gamma)
        layer.beta.copy_(beta)
    y = layer.fapply(x, train=True)
    got = torch.autograd.grad(y, (x, layer.gamma, layer.beta), dy)
    want_y = F.layer_norm(x, (shape[-1],), gamma, beta, 1e-6)
    want = torch.autograd.grad(want_y, (x, gamma, beta), dy)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(layer.fapply(x), y, rtol=0, atol=0)  # no train-mode state


@pytest.mark.parametrize("shape", [(2, 5, 7, 12), (6, 20)], ids=["nhwc", "rows"])
def test_layer_norm_in_fp32_under_bf16(bf16, shape):
    """bf16 activations are normalised in fp32 and handed on in bf16, as
    batch norm's are; the gradients are those of the fp32 function."""
    x, gamma, beta, dy = _leaves(shape, 2, torch.bfloat16)
    layer = L.LayerNormLayer("ln", shape[-1])
    with torch.no_grad():
        layer.gamma.copy_(gamma)
        layer.beta.copy_(beta)
    y = layer.fapply(x, train=True)
    assert y.dtype == torch.bfloat16
    got = torch.autograd.grad(y, (x, layer.gamma, layer.beta), dy)
    want_y = F.layer_norm(x.float(), (shape[-1],), gamma, beta, 1e-6)
    want = torch.autograd.grad(want_y.bfloat16(), (x, gamma, beta), dy)
    torch.testing.assert_close(y, want_y.bfloat16(), rtol=0, atol=0)
    assert got[0].dtype == torch.bfloat16
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layer_norm_counts_launches_by_layout():
    from dorknet_tpu_torch.ops.norm import layer_norm

    before = dict(layer_norm.launches_by_layout)
    gamma, beta = torch.ones(4), torch.zeros(4)
    layer_norm(torch.randn(2, 3, 3, 4), gamma, beta)
    layer_norm(torch.randn(2, 3, 3, 4), gamma, beta)
    layer_norm(torch.randn(2, 4), gamma, beta)
    assert layer_norm.launches_by_layout == {"nhwc": before["nhwc"] + 2,
                                             "rows": before["rows"] + 1}
    with pytest.raises(ValueError, match="takes"):
        layer_norm(torch.randn(2, 3, 4), gamma, beta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_is_the_exact_erf_gelu(dtype):
    x = torch.linspace(-6, 6, 97).to(dtype).requires_grad_()
    y = L.GELU("g").fapply(x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    xr = x.detach().requires_grad_()
    want = F.gelu(xr, approximate="none")
    (want_dx,) = torch.autograd.grad(want, xr, torch.ones_like(want))
    assert y.dtype == dtype
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    # not the tanh approximation
    assert not torch.equal(y, F.gelu(x.detach(), approximate="tanh"))


@pytest.mark.parametrize("shape", [(2, 3, 4, 6), (5, 6)])
def test_layer_scale_values_and_grads(shape):
    layer = L.LayerScale("s", shape[-1])
    assert torch.equal(layer.scale.detach(), torch.full((shape[-1],), 1e-6))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        layer.scale.copy_(torch.randn(shape[-1], generator=g))
    x = torch.randn(shape, generator=g).requires_grad_()
    dy = torch.randn(shape, generator=g)
    y = layer.fapply(x)
    dx, ds = torch.autograd.grad(y, (x, layer.scale), dy)
    s = layer.scale.detach()
    torch.testing.assert_close(y, x.detach() * s, rtol=0, atol=0)
    torch.testing.assert_close(dx, dy * s, rtol=0, atol=0)
    torch.testing.assert_close(ds, (dy * x.detach()).reshape(-1, shape[-1]).sum(0),
                               rtol=1e-6, atol=1e-6)


def _stepped(seed=5):
    """A small ConvNeXt after one AdamW step, its gradients handed to the
    layers by ``backward()``."""
    net = _small(seed)
    X, y = _batches(6, steps=1)
    net.forward(X[0], y[0])
    net.backward()
    AdamW(net, 1e-3).update_weights()
    return net, X[0]


def test_h5_json_round_trip(tmp_path):
    h5py = pytest.importorskip("h5py")
    net, X = _stepped()
    h5f, jsf = str(tmp_path / "w.h5"), str(tmp_path / "s.json")
    net.save_weights_to_h5(h5f)
    net.save_layer_structure_to_json(jsf)
    back = FeedForwardNetwork("x")
    back.load_network_from_json_and_h5(jsf, h5f)
    assert repr(back) == repr(net)
    for (na, pa), (nb, pb) in zip(net.named_parameters(), back.named_parameters(), strict=True):
        assert na == nb and torch.equal(pa, pb)
    layers = {m.layer_name: m for m in net.modules() if isinstance(m, L.Layer)}
    with h5py.File(h5f, "r") as f:
        assert f["stem_ln/layer_info"].attrs["type"] == "LayerNormLayer"
        assert float(f["stem_ln/layer_info"].attrs["eps"]) == 1e-6
        assert f["s1b0_scale/layer_info"].attrs["type"] == "LayerScale"
        assert f["s1b0_gelu/layer_info"].attrs["type"] == "GELU"
        np.testing.assert_array_equal(f["s1b0_scale/grads/scale"][:],
                                      layers["s1b0_scale"].grads["scale"].numpy())
        np.testing.assert_array_equal(f["head_ln/grads/gamma"][:],
                                      layers["head_ln"].grads["gamma"].numpy())
    _, want = net.forward(X, test_mode=True)
    _, got = back.forward(X, test_mode=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with h5py.File(h5f, "r") as f:  # a LayerScale's grads are read back too
        scale = L.LayerScale("s1b0_scale")
        scale.load_from_h5(f)
        np.testing.assert_array_equal(scale.grads["scale"], f["s1b0_scale/grads/scale"][:])


def test_torch_io_round_trip(tmp_path):
    net, X = _stepped()
    path = torch_io.save_checkpoint(str(tmp_path / "c.pt"), net)
    back = _small(seed=8)
    ptrs = [p.data_ptr() for p in back.parameters()]
    torch_io.load_checkpoint(path, back)
    assert [p.data_ptr() for p in back.parameters()] == ptrs
    for a, b in zip(net.parameters(), back.parameters(), strict=True):
        assert torch.equal(a, b)
    torch.testing.assert_close(back.forward(X, test_mode=True)[1],
                               net.forward(X, test_mode=True)[1], rtol=0, atol=0)


def _synthetic(seed):
    """Parameters of every kind a network holds (a conv weight, a dense
    weight, a bias, a batch norm's (1, C, 1, 1) gamma, a LayerNorm gain,
    a layer scale) and three steps of gradients for them."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(6, 3, 4, 4), (12, 5), (6,), (1, 6, 1, 1), (6,), (6,)]
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 10.0 ** -k for k, s in enumerate(shapes)]
             for _ in range(3)]
    return params, grads


class _Holder:
    """What ``Optimiser`` reads of a network: its device."""

    def device(self):
        return torch.device("cpu")


def test_adamw_matches_torch_optim_adamw():
    params, steps = _synthetic(10)
    mine = [p.clone() for p in params]
    theirs = [p.clone().requires_grad_() for p in params]
    opt = AdamW(_Holder(), 2e-2, beta1=0.8, beta2=0.99, eps=1e-6, weight_decay=0.1)
    cache = opt.init_cache(mine)
    wd = [p for p in theirs if p.dim() >= 2 and sum(n > 1 for n in p.shape) >= 2]
    rest = [p for p in theirs if not any(p is q for q in wd)]
    ref = torch.optim.AdamW([{"params": wd, "weight_decay": 0.1},
                             {"params": rest, "weight_decay": 0.0}],
                            lr=2e-2, betas=(0.8, 0.99), eps=1e-6)
    for grads in steps:
        with torch.no_grad():
            opt.apply_update(mine, grads, cache, opt.device_lr())
        for p, g in zip(theirs, grads):
            p.grad = g.clone()
        ref.step()
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)
    n = len(params)
    assert cache[2 * n].shape == () and float(cache[2 * n]) == 3.0
    for a, p in zip(cache[:n], theirs):
        torch.testing.assert_close(a, ref.state[p]["exp_avg"], rtol=1e-6, atol=1e-9)
    for a, p in zip(cache[n:2 * n], theirs):
        torch.testing.assert_close(a, ref.state[p]["exp_avg_sq"], rtol=1e-6, atol=1e-12)
    assert opt.hyper_key() == (0.8, 0.99, 1e-6, 0.1)


def test_adamw_decays_the_weights_alone():
    """With zero gradients the moments stay 0 and only the decay moves a
    parameter: the two weights shrink by (1 - lr wd)^3, the bias, the
    batch norm's (1, C, 1, 1) gamma, the LayerNorm gain and the layer scale
    stay as they were."""
    params, _ = _synthetic(11)
    before = [p.clone() for p in params]
    opt = AdamW(_Holder(), 0.1, weight_decay=0.5)
    cache = opt.init_cache(params)
    for _ in range(3):
        with torch.no_grad():
            opt.apply_update(params, [torch.zeros_like(p) for p in params], cache,
                             opt.device_lr())
    assert [decayed(p) for p in params] == [True, True, False, False, False, False]
    for p, b in zip(params, before):
        want = b * (1 - 0.1 * 0.5) ** 3 if decayed(p) else b
        torch.testing.assert_close(p, want, rtol=1e-6, atol=0)


def test_adamw_step_count_lives_with_the_parameters():
    net = _small()
    trainer = Trainer(net, AdamW(net, 1e-3), device="cpu")
    X, y = _batches(12)
    for k in range(3):
        trainer.step(X[k], y[k])
    n = len(list(net.parameters()))
    assert len(trainer._cache) == 2 * n + 1
    step = trainer._cache[-1]
    assert step.shape == () and step.dtype == torch.float32 and float(step) == 3.0
    assert all(m.shape == p.shape for m, p in zip(trainer._cache[:n], net.parameters()))


def test_checkpoint_after_step_two_resumes_step_three(tmp_path):
    """A ``torch_io`` checkpoint after step 2 restored into a fresh network
    and trainer: step 3 gives the loss and parameters of an uninterrupted
    run, bit for bit, the step count (and with it the bias corrections)
    carried in the file."""
    X, y = _batches(13)
    whole = _small()
    t_whole = Trainer(whole, AdamW(whole, 1e-3), device="cpu")
    first = _small()
    t_first = Trainer(first, AdamW(first, 1e-3), device="cpu")
    for k in range(2):
        t_whole.step(X[k], y[k])
        t_first.step(X[k], y[k])
    path = torch_io.save_checkpoint(str(tmp_path / "c.pt"), first, t_first)
    fresh = _small(seed=99)
    t_fresh = Trainer(fresh, AdamW(fresh, 1e-3), device="cpu")
    torch_io.load_checkpoint(path, fresh, t_fresh)
    assert float(t_fresh._cache[-1]) == 2.0
    want, _ = t_whole.step(X[2], y[2])
    got, _ = t_fresh.step(X[2], y[2])
    assert float(got) == float(want)
    for a, b in zip(fresh.parameters(), whole.parameters(), strict=True):
        assert torch.equal(a, b)
    assert float(t_fresh._cache[-1]) == float(t_whole._cache[-1]) == 3.0


def test_convnext_t_size_layers_and_names():
    from benchmark_torch.reference import convnext_t
    from benchmark_torch.reference.plain import layer_table

    net = ConvNeXt("convnext_t")
    names = {"{}/{}".format(m.layer_name, n): tuple(p.shape)
             for m in net.modules() if isinstance(m, L.Layer)
             for n, p in m.named_parameters(recurse=False)}
    assert sum(math.prod(s) for s in names.values()) == 28_589_128
    modules = list(net.modules())
    assert sum(isinstance(m, L.LayerNormLayer) for m in modules) == 23
    assert sum(isinstance(m, L.ResidualBlock) for m in modules) == 18
    assert sum(isinstance(m, L.GELU) for m in modules) == 18
    assert not any(isinstance(m, L.BatchNormLayer) for m in modules)
    assert all(m.weight_regulariser is None for m in modules if isinstance(m, L.Layer))
    dws = [m for m in modules if isinstance(m, L.DepthwiseConvLayer)]
    assert len(dws) == 18 and all((m.f_rows, m.padding, m.with_bias) == (7, 3, True)
                                  for m in dws)
    cfg = {"image_hw": [32, 32], "num_classes": 1000, "depths": [3, 3, 9, 3],
           "dims": [96, 192, 384, 768], "ln_eps": 1e-6}
    spec, _, _ = layer_table(convnext_t.forward, cfg, 1)
    assert {n: math.prod(s) for n, s, _, _ in spec} == {n: math.prod(s)
                                                        for n, s in names.items()}


def test_convnext_sizes_from_a_configuration_file():
    """The benchmark's configuration hands the sizes over as json lists."""
    with open("benchmark_torch/configs/convnext_t.json") as f:
        kwargs = json.load(f)["program"]["kwargs"]
    net = ConvNeXt("c", **dict(kwargs, dims=[8, 16, 24, 32], num_classes=3))
    _, probs = net.forward(np.zeros((2, 3, 64, 64), np.float32), test_mode=True)
    assert tuple(probs.shape) == (2, 3)
    with pytest.raises(ValueError, match="one depth a stage"):
        ConvNeXt("c", depths=(1, 1), dims=(8, 16, 24))
