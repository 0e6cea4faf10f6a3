"""ConvNeXt-T (Liu et al. 2022, "A ConvNet for the 2020s", arXiv:2201.03545,
section 2 and figure 4; the published ``convnext_tiny`` of
github.com/facebookresearch/ConvNeXt) from the sizes in its configuration
file: a 4x4/s4 "patchify" stem conv with bias and a LayerNorm; four stages
of ``depths`` blocks at ``dims`` channels, stages 2-4 entered through a
LayerNorm and a 2x2/s2 conv with bias; global average pooling, a LayerNorm
and a dense classifier. A block: a 7x7 depthwise conv with bias (padding
3), a LayerNorm, a pointwise conv to 4C with bias, GELU (exact erf), a
pointwise conv back to C with bias, a per-channel layer scale, and the
identity skip added. Every LayerNorm normalises over the channels with
``ln_eps`` (1e-6). No weight is regularised (AdamW decays them). Layer
names are the port's checkpoint names.

Departures from the paper: no stochastic depth (the published drop path
0.1; its per-sample mask is drawn from an RNG the program and this
reference would not share), and the benchmark's weights (``harness/
weights.py``), not the published truncated-normal 0.02 with zero biases
and layer scales of 1e-6."""

from benchmark_torch.reference.plain import gelu


def _block(ex, name, x, eps):
    C = x.shape[1]
    h = ex.dw(name + "_dw", x, 7, 1, 3, bias=True)
    h = ex.ln(name + "_ln", h, eps)
    h = gelu(ex.pw(name + "_pw1", h, 4 * C, reg=False, bias=True))
    h = ex.pw(name + "_pw2", h, C, reg=False, bias=True)
    return x + ex.scale(name + "_scale", h)


def forward(ex, x, cfg):
    eps, dims = cfg["ln_eps"], cfg["dims"]
    h = ex.ln("stem_ln", ex.conv("stem", x, dims[0], 4, 4, 0, reg=False, bias=True), eps)
    for i, (depth, dim) in enumerate(zip(cfg["depths"], dims), start=1):
        if i > 1:
            h = ex.ln("down{}_ln".format(i), h, eps)
            h = ex.conv("down{}".format(i), h, dim, 2, 2, 0, reg=False, bias=True)
        for j in range(depth):
            h = _block(ex, "s{}b{}".format(i, j), h, eps)
    h = ex.ln("head_ln", ex.gap(h), eps)
    return ex.dense("classifier", h, cfg["num_classes"], reg=False)
