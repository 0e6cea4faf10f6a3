"""MobileNet-V2 (counterpart of ``dorknet_tpu/models/mobilenet_v2.py``).
Each inverted residual is expand-pointwise -> BN -> ReLU6 -> depthwise 3x3
(stride s) -> BN -> ReLU6 -> project-pointwise -> BN, in a ResidualBlock
with an identity skip and an ``IdentityLayer`` join (the linear bottleneck)
when the stride is 1 and the channels match, else a plain stack. Its 17
depthwise layers take the hand-written kernels (padding 1); layer names and
construction order are the JAX package's, so the same ``np.random.seed``
builds bit-equal weights."""

from dorknet_tpu_torch.layers import (
    BatchNormLayer, ConvLayer, DenseLayer, DepthwiseConvLayer, GlobalAveragePoolingLayer,
    IdentityLayer, PointwiseConvLayer, ReLu6, ResidualBlock, SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def add_inverted_residual(net, name, in_ch, out_ch, stride, expansion, kernel=3, reg=0.0001):
    """Append one linear-bottleneck MBConv block to ``net`` (shared with
    EfficientNet-Lite, whose 5x5 stages take ``F.conv2d(groups=C)``)."""
    hidden = in_ch * expansion
    layer_list = []
    if expansion != 1:
        layer_list += [
            PointwiseConvLayer(name + "_expand", filter_block_shape=(hidden, in_ch),
                               with_bias=False, weight_regulariser=l2(reg)),
            BatchNormLayer(name + "_expand_bn", incoming_chans=hidden),
            ReLu6(name + "_expand_relu6"),
        ]
    layer_list += [
        DepthwiseConvLayer(name + "_dw", filter_block_shape=(hidden, kernel, kernel),
                           stride=stride, padding=kernel // 2, with_bias=False),
        BatchNormLayer(name + "_dw_bn", incoming_chans=hidden),
        ReLu6(name + "_dw_relu6"),
        PointwiseConvLayer(name + "_project", filter_block_shape=(out_ch, hidden),
                           with_bias=False, weight_regulariser=l2(reg)),
        BatchNormLayer(name + "_project_bn", incoming_chans=out_ch),
    ]
    if stride == 1 and in_ch == out_ch:
        net.add_layer(ResidualBlock(name, layer_list=layer_list, skip_projection=None,
                                    post_skip_activation=IdentityLayer(name + "_join")))
    else:
        for layer in layer_list:
            net.add_layer(layer)


class MobileNetV2(FeedForwardNetwork):
    # (expansion t, out channels c, repeats n, first stride s)
    _CFG = [
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    ]

    def __init__(self, name, num_classes=1000, width_mult=1.0, load_layers=True):
        super().__init__(name)
        if not load_layers:
            return
        in_ch = _make_divisible(32 * width_mult)
        self.add_layer(ConvLayer("stem", filter_block_shape=(in_ch, 3, 3, 3), stride=2,
                                 padding=1, with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("stem_bn", incoming_chans=in_ch))
        self.add_layer(ReLu6("stem_relu6"))
        block = 0
        for t, c, n, s in self._CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                add_inverted_residual(self, "ir{}".format(block), in_ch, out_ch,
                                      s if i == 0 else 1, t)
                in_ch = out_ch
                block += 1
        last = _make_divisible(1280 * max(1.0, width_mult))
        self.add_layer(PointwiseConvLayer("head", filter_block_shape=(last, in_ch),
                                          with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("head_bn", incoming_chans=last))
        self.add_layer(ReLu6("head_relu6"))
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(DenseLayer("classifier", incoming_chans=last, output_dim=num_classes,
                                  weight_regulariser=l2(0.0001)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))
