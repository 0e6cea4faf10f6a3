"""ResNet-18-depsep, the reference's flagship (Dorknet's
``examples/imagenet_dogs_225_resnet_18_depsep.py``), from the sizes in its
configuration file: a k x k stride-2 stem conv, a strided pointwise conv,
residual blocks of two depthwise-separable layers each ([3x3 depthwise, BN,
pointwise, BN] with a ReLU after the first), a stride-2 pointwise skip
projection where a block downsamples, a ReLU after the join, global average
pooling and a dense classifier. Layer names are the model's checkpoint
names."""

from benchmark_torch.reference.plain import relu


def _sep(ex, name, x, out_ch, stride, final_relu):
    h = ex.dw(name + "_dw", x, 3, stride, 1)
    h = ex.bn(name + "_dw_bn", h)
    h = ex.pw(name + "_pw", h, out_ch)
    h = ex.bn(name + "_pw_bn", h)
    return relu(h) if final_relu else h


def forward(ex, x, cfg):
    stem = cfg["stem"]
    h = ex.conv("conv0", x, stem["channels"], stem["kernel"], stem["stride"], stem["padding"])
    h = relu(ex.bn("conv0_bn", h))
    h = ex.pw("pw0", h, cfg["pw0_channels"], stride=2)
    h = relu(ex.bn("pw0_bn", h))
    for i, (out_ch, in_ch, down) in enumerate(cfg["blocks"], start=1):
        if h.shape[1] != in_ch:
            raise ValueError("block {} takes {} channels, gets {}".format(i, in_ch, h.shape[1]))
        name = "res{}".format(i)
        t = _sep(ex, name + "_dw1", h, out_ch, 2 if down else 1, final_relu=True)
        t = _sep(ex, name + "_dw2", t, out_ch, 1, final_relu=False)
        skip = ex.pw(name + "_pw_skip", h, out_ch, stride=2, reported=False) if down else h
        h = relu(t + skip)
    return ex.dense("dense1", ex.gap(h), cfg["num_classes"])
