"""MobileNet-V3 (Howard et al. 2019, arXiv:1905.02244, tables 1 and 2) from
the sizes in its configuration file. A bneck is [1x1 expand, BN, NL] (left
out where the expanded width equals the input's), a k x k depthwise conv
(padding k // 2), BN, NL, an optional squeeze-excite (reduced width
make_divisible(exp / 4)), a 1x1 projection and BN, with a linear residual
join where the stride is 1 and the widths match. NL is ReLU or hard-swish by
the table. The head: a 1x1 conv, BN, hard-swish, global average pooling, a
dense layer, hard-swish and the classifier. Layer names are the port's
checkpoint names."""

from benchmark_torch.reference.plain import hard_swish, make_divisible, relu


def forward(ex, x, cfg):
    width = cfg["width_mult"]
    act = {False: relu, True: hard_swish}
    in_ch = make_divisible(cfg["stem_channels"] * width)
    h = hard_swish(ex.bn("stem_bn", ex.conv("stem", x, in_ch, 3, 2, 1)))
    for i, (k, exp, out, use_se, hs, stride) in enumerate(cfg["bneck"]):
        name = "bneck{}".format(i)
        out_ch, exp_ch = make_divisible(out * width), make_divisible(exp * width)
        t = h
        if exp_ch != in_ch:
            t = act[hs](ex.bn(name + "_expand_bn", ex.pw(name + "_expand", t, exp_ch)))
        t = act[hs](ex.bn(name + "_dw_bn", ex.dw(name + "_dw", t, k, stride, k // 2)))
        if use_se:
            t = ex.se(name + "_se", t, make_divisible(exp_ch // 4))
        t = ex.bn(name + "_project_bn", ex.pw(name + "_project", t, out_ch))
        h = t + h if stride == 1 and in_ch == out_ch else t
        in_ch = out_ch
    last = make_divisible(cfg["head_channels"] * width)
    h = hard_swish(ex.bn("head_bn", ex.pw("head", h, last)))
    h = hard_swish(ex.dense("head_fc", ex.gap(h), cfg["fc_dim"]))
    return ex.dense("classifier", h, cfg["num_classes"])
