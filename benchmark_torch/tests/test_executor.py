"""The plain executor's layers against ``torch.nn.functional``, and the
configured references' parameter specs and layer tables, which the
executor's LayerNorm, channel scale, GELU and biases leave as they were."""

import json

import pytest
import torch
import torch.nn.functional as F

from benchmark_torch.harness import weights
from benchmark_torch.harness.cell import BENCH_DIR
from benchmark_torch.reference import mnv3l, resnet18dw, resnet50
from benchmark_torch.reference.plain import Executor, gelu, layer_table
from benchmark_torch.work import counts

SHAPES = [(2, 8, 5, 7), (3, 16, 9, 9)]


def _rand(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _spec_and_rows(call, x):
    """The spec entries and table rows one layer records."""
    ex = Executor("spec", batch=x.shape[0])
    call(ex, torch.zeros((1,) + tuple(x.shape[1:])))
    return ex.spec, ex.layers


@pytest.mark.parametrize("shape", SHAPES + [(4, 12)])
def test_ln_against_layer_norm(shape):
    """Over the channels at every position of NCHW, or over each row of
    (N, C): ``F.layer_norm`` on the channel-last view."""
    x, C = _rand(shape, 1) * 3 + 1, shape[1]
    params = {"n/gamma": _rand((C,), 2), "n/beta": _rand((C,), 3)}
    for mode in ("train", "eval"):
        y = Executor(mode, params).ln("n", x, 1e-6)
        last = x.movedim(1, -1)
        want = F.layer_norm(last, (C,), params["n/gamma"], params["n/beta"], 1e-6).movedim(-1, 1)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    spec, rows = _spec_and_rows(lambda ex, x: ex.ln("n", x, 1e-6), x)
    assert spec == [("n/gamma", (C,), None, "gamma"), ("n/beta", (C,), None, "beta")]
    assert rows == [dict(op="ln", name="n", x=shape, y=shape)]
    assert counts.layer_flops(rows[0]) == 0


@pytest.mark.parametrize("shape", SHAPES + [(4, 12)])
def test_scale_and_gelu(shape):
    x, C = _rand(shape, 4), shape[1]
    s = _rand((C,), 5)
    view = (1, C) + (1,) * (len(shape) - 2)
    torch.testing.assert_close(Executor("train", {"ls/scale": s}).scale("ls", x),
                               x * s.view(view), rtol=0, atol=0)
    torch.testing.assert_close(gelu(x), F.gelu(x), rtol=0, atol=0)
    assert not torch.equal(gelu(x), F.gelu(x, approximate="tanh"))
    spec, rows = _spec_and_rows(lambda ex, x: ex.scale("ls", x), x)
    assert spec == [("ls/scale", (C,), None, "gamma")]
    assert rows == [dict(op="scale", name="ls", x=shape, y=shape)]
    assert counts.layer_flops(rows[0]) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_biased_convolutions(shape):
    """``bias=True`` adds ``<name>/bias`` after the weights: F.conv2d with
    ``bias=``; ``bias=False`` keeps the spec and the output bias-free."""
    N, C, H, W = shape
    x, O = _rand(shape, 6), 2 * C
    k7 = _rand((C, 7, 7), 7)
    wc, wp, b = _rand((O, C, 3, 3), 8), _rand((O, C), 9), _rand((O,), 10)
    bd = _rand((C,), 11)
    ex = Executor("train", {"c/weights": wc, "c/bias": b, "d/weights": k7, "d/bias": bd,
                            "p/weights": wp, "p/bias": b})
    torch.testing.assert_close(ex.conv("c", x, O, 3, 2, 1, bias=True),
                               F.conv2d(x, wc, b, stride=2, padding=1))
    torch.testing.assert_close(ex.dw("d", x, 7, 1, 3, bias=True),
                               F.conv2d(x, k7.unsqueeze(1), bd, padding=3, groups=C))
    torch.testing.assert_close(ex.pw("p", x, O, stride=2, bias=True),
                               F.conv2d(x, wp[:, :, None, None], b, stride=2),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ex.pw("p", x, O), F.conv2d(x, wp[:, :, None, None]),
                               rtol=1e-5, atol=1e-5)

    def layers(ex, x, bias):
        h = ex.conv("c", x, O, 3, 2, 1, bias=bias)
        h = ex.dw("d", h, 7, 1, 3, bias=bias)
        return ex.pw("p", h, O, bias=bias)

    spec, rows = _spec_and_rows(lambda ex, x: layers(ex, x, True), x)
    assert [(n, kind) for n, _, _, kind in spec] == [
        ("c/weights", "weight"), ("c/bias", "bias"), ("d/weights", "weight"),
        ("d/bias", "bias"), ("p/weights", "weight"), ("p/bias", "bias")]
    assert [s for _, s, _, _ in spec if len(s) == 1] == [(O,), (O,), (O,)]
    plain_spec, plain_rows = _spec_and_rows(lambda ex, x: layers(ex, x, False), x)
    assert plain_spec == [e for e in spec if e[3] != "bias"]
    assert plain_rows == rows
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    assert [(r["op"], r["y"]) for r in rows] == [("conv", (N, O, Ho, Wo)),
                                                  ("dw", (N, O, Ho, Wo)),
                                                  ("pw", (N, O, Ho, Wo))]


# the parent's counts of the configured references, at their configured sizes
CONFIGURED = [
    ("resnet18dw", resnet18dw, 107, 1_508_344, 34, 1_627_952_640),
    ("mnv3l", mnv3l, 174, 5_483_032, 46, 1_288_700_544),
    ("resnet50", resnet50, 161, 25_557_032, 53, 24_299_077_632),
]


@pytest.mark.parametrize("name,ref,leaves,n_params,n_bn,train_flops", CONFIGURED,
                         ids=[c[0] for c in CONFIGURED])
def test_configured_references_unchanged(name, ref, leaves, n_params, n_bn, train_flops):
    """Leaves, parameters and trained FLOPs as before; the table's batch
    norms are the spec's ``"gamma"`` leaves, so their running statistics
    are the same with or without the table."""
    cfg = json.loads((BENCH_DIR / "configs" / (name + ".json")).read_text())
    spec, layers, _ = layer_table(ref.forward, cfg, 2)
    assert len(spec) == leaves
    assert sum(torch.Size(shape).numel() for _, shape, _, _ in spec) == n_params
    gammas = [n[:-len("/gamma")] for n, _, _, kind in spec if kind == "gamma"]
    assert weights.bn_names(layers) == gammas and len(gammas) == n_bn
    assert counts.train_flops_per_image(layers) == train_flops
    params = {n: torch.ones(shape) for n, shape, _, _ in spec}
    with_table = weights.train_stats(spec, params, layers)
    assert list(with_table) == list(weights.train_stats(spec, params)) == gammas
