"""The work counts against shapes worked by hand."""

import json

import pytest

from benchmark_torch.harness.cell import BENCH_DIR
from benchmark_torch.reference import mnv3l, resnet18dw
from benchmark_torch.reference.plain import layer_table
from benchmark_torch.work import counts


def _cfg(name):
    return json.loads((BENCH_DIR / "configs" / (name + ".json")).read_text())


def _resnet18dw_by_hand():
    """Forward FLOPs of one 225 px image, layer by layer."""
    f = 2 * 112 * 112 * 64 * 3 * 5 * 5          # stem conv, 5x5 stride 2 -> 112
    f += 2 * 56 * 56 * 64 * 64                  # pw0, stride 2 -> 56
    H, c = 56, 64
    for out, down in ((64, 0), (64, 0), (128, 1), (128, 0), (256, 1), (256, 0), (512, 1),
                      (512, 0)):
        Ho = H // 2 if down else H
        f += 2 * Ho * Ho * c * 9 + 2 * Ho * Ho * out * c       # dw1 (stride), pw1
        f += 2 * Ho * Ho * out * 9 + 2 * Ho * Ho * out * out   # dw2, pw2
        if down:
            f += 2 * Ho * Ho * out * c                         # the skip projection
        H, c = Ho, out
    return f + 2 * 512 * 120


def test_resnet18dw_forward_flops():
    _, layers, _ = layer_table(resnet18dw.forward, _cfg("resnet18dw"), 1)
    assert counts.forward_flops_per_image(layers) == _resnet18dw_by_hand() == 582_791_680


def test_train_flops_leave_out_the_stem_input_gradient():
    """3 x the forward, less the stem conv's input gradient (as many FLOPs
    as its forward): 2 x 112 x 112 x 64 x 3 x 5 x 5 at 225 px."""
    _, layers, _ = layer_table(resnet18dw.forward, _cfg("resnet18dw"), 2)
    assert counts.train_flops_per_image(layers) == 3 * 582_791_680 - 120_422_400
    _, layers, _ = layer_table(mnv3l.forward, _cfg("mnv3l"), 2)
    stem = 2 * 112 * 112 * 16 * 3 * 3 * 3
    assert counts.train_flops_per_image(layers) == \
        3 * counts.forward_flops_per_image(layers) - stem


def test_mnv3l_forward_flops():
    """430,165,120 without the squeeze-excite FCs (the JAX package's count
    leaves them out), and their 2 x 2 x C x Cr a block besides."""
    _, layers, _ = layer_table(mnv3l.forward, _cfg("mnv3l"), 1)
    se = sum(counts.layer_flops(l) for l in layers if l["op"] == "se")
    by_hand = sum(4 * c * r for c, r in ((72, 24), (120, 32), (120, 32), (480, 120),
                                         (672, 168), (672, 168), (960, 240), (960, 240)))
    assert se == by_hand
    assert counts.forward_flops_per_image(layers) - se == 430_165_120


def test_kernel_counts():
    assert len(counts.dw3x3_layers(layer_table(resnet18dw.forward, _cfg("resnet18dw"), 2)[1])) \
        == 16
    _, layers, _ = layer_table(mnv3l.forward, _cfg("mnv3l"), 2)
    assert len(counts.dw3x3_layers(layers)) == 9 and len(counts.bn_layers(layers)) == 46
    # 56 x 56 x 64 in, stride 2 -> 28 x 28 x 64 out, fp32, batch 120
    assert counts.dw_bytes(120, 56, 56, 64, 2) == (120 * 56 * 56 * 64 + 120 * 28 * 28 * 64) * 4
    # bytes bound at 3.35 TB/s
    assert counts.dw_bound_ms(120, 56, 56, 64, 1) == pytest.approx(
        120 * 56 * 56 * 64 * 8 / 3.35e12 * 1e3)
    # k = 3 by default; a 7x7 (padding 3) keeps the grid, 2 x 49 flops an
    # output element, still bound by its bytes at this width
    assert counts.dw_bound_ms(120, 56, 56, 64, 2, k=3) == counts.dw_bound_ms(120, 56, 56, 64, 2)
    assert counts.dw_bytes(128, 56, 56, 96, 1, k=7) == 2 * 128 * 56 * 56 * 96 * 4
    assert counts.dw_bound_ms(128, 56, 56, 96, 1, k=7) == pytest.approx(
        max(2 * 128 * 56 * 56 * 96 * 4 / 3.35e12, 98 * 128 * 56 * 56 * 96 / 67e12) * 1e3)
    assert counts.bn_stats_bound_ms(120, 112, 112, 64) == pytest.approx(
        120 * 112 * 112 * 64 * 4 / 3.35e12 * 1e3)
    # 60 crops of 225 x 225 x 3, read and written once
    assert counts.augment_bound_ms(60, 225, 225, 0) == pytest.approx(
        max(60 * 3 * 2 * 225 * 225 / 3.35e12, 39 * 60 * 225 * 225 / 67e12) * 1e3)
