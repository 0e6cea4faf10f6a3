"""ResNet-50 v1.5 (He et al. 2015, arXiv:1512.03385, table 1; the stride
placed as torchvision's ``resnet50`` and the MLPerf Training reference place
it) from the sizes in its configuration file: a 7x7/s2 stem conv, BN, ReLU
and a 3x3/s2 max pool with padding 1; then stages of bottlenecks [1x1
reduce, BN, ReLU, 3x3 conv carrying the stage's stride, BN, ReLU, 1x1
expand, BN], each stage's first block projecting its skip through a strided
1x1 conv and a BN; a ReLU after each join, global average pooling and a
dense classifier. Every conv and the classifier carry l2; the skip
projections' terms are left out of the reported loss, as the port reports
it. The pool is plain ``F.max_pool2d`` here and counts no FLOPs. Layer names
are the port's checkpoint names."""

import torch.nn.functional as F

from benchmark_torch.reference.plain import relu


def _bottleneck(ex, name, x, width, out_ch, stride):
    h = relu(ex.bn(name + "_reduce_bn", ex.pw(name + "_reduce", x, width)))
    h = relu(ex.bn(name + "_conv3_bn", ex.conv(name + "_conv3", h, width, 3, stride, 1)))
    h = ex.bn(name + "_expand_bn", ex.pw(name + "_expand", h, out_ch))
    skip = x
    if stride != 1 or x.shape[1] != out_ch:
        skip = ex.bn(name + "_skip_bn",
                     ex.pw(name + "_skip", x, out_ch, stride=stride, reported=False))
    return relu(h + skip)


def forward(ex, x, cfg):
    stem = cfg["stem"]
    h = ex.conv("stem", x, stem["channels"], stem["kernel"], stem["stride"], stem["padding"])
    h = relu(ex.bn("stem_bn", h))
    pool = cfg["stem_pool"]
    h = F.max_pool2d(h, kernel_size=pool["window"], stride=pool["stride"],
                     padding=pool["padding"])
    for si, (width, out_ch, blocks, stride) in enumerate(cfg["stages"], start=1):
        for b in range(blocks):
            h = _bottleneck(ex, "s{}b{}".format(si, b), h, width, out_ch,
                            stride if b == 0 else 1)
    return ex.dense("classifier", ex.gap(h), cfg["num_classes"])
