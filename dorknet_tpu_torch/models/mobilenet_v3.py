"""MobileNet-V3 Small and Large (counterpart of
``dorknet_tpu/models/mobilenet_v3.py``; Howard et al. 2019, tables 1 and
2). Each bneck is [expand-pointwise -> BN -> NL] (left out where the
expanded width equals the input's, as in Large's first block) ->
depthwise k x k (stride s) -> BN -> NL -> [squeeze-excite] ->
project-pointwise -> BN, in a ResidualBlock with an ``IdentityLayer`` join
when the stride is 1 and the channels match. NL is ReLU or hard-swish by
the stage table. The 3x3 depthwise layers take the hand-written kernels;
the 5x5 ones (padding 2) take ``F.conv2d(groups=C)``, as the JAX package
leaves them to XLA. Layer names and construction order are the JAX
package's, so the same ``np.random.seed`` builds bit-equal weights."""

from dorknet_tpu_torch.layers import (
    BatchNormLayer, ConvLayer, DenseLayer, DepthwiseConvLayer, GlobalAveragePoolingLayer,
    HardSwish, IdentityLayer, PointwiseConvLayer, ReLu, ResidualBlock, SoftmaxWithCrossEntropy,
    SqueezeExciteLayer,
)
from dorknet_tpu_torch.models.mobilenet_v2 import _make_divisible
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2


class _MobileNetV3(FeedForwardNetwork):
    """The shared builder; subclasses give the stage table and head widths."""

    # (kernel k, expanded channels, out channels, use_se, use_hswish, stride)
    _CFG = []
    _HEAD_CONV = 576  # channels of the last pointwise conv
    _FC_DIM = 1024    # hidden width of the two-stage classifier head

    def _act(self, name, hswish):
        return HardSwish(name) if hswish else ReLu(name)

    def _bneck(self, name, in_ch, k, exp, out_ch, use_se, hswish, stride, reg=0.0001):
        layer_list = []
        if exp != in_ch:
            layer_list += [
                PointwiseConvLayer(name + "_expand", filter_block_shape=(exp, in_ch),
                                   with_bias=False, weight_regulariser=l2(reg)),
                BatchNormLayer(name + "_expand_bn", incoming_chans=exp),
                self._act(name + "_expand_act", hswish),
            ]
        layer_list += [
            DepthwiseConvLayer(name + "_dw", filter_block_shape=(exp, k, k), stride=stride,
                               padding=k // 2, with_bias=False),
            BatchNormLayer(name + "_dw_bn", incoming_chans=exp),
            self._act(name + "_dw_act", hswish),
        ]
        if use_se:
            layer_list.append(SqueezeExciteLayer(name + "_se", incoming_chans=exp,
                                                 reduced_chans=_make_divisible(exp // 4),
                                                 weight_regulariser=l2(reg)))
        layer_list += [
            PointwiseConvLayer(name + "_project", filter_block_shape=(out_ch, exp),
                               with_bias=False, weight_regulariser=l2(reg)),
            BatchNormLayer(name + "_project_bn", incoming_chans=out_ch),
        ]
        if stride == 1 and in_ch == out_ch:
            self.add_layer(ResidualBlock(name, layer_list=layer_list, skip_projection=None,
                                         post_skip_activation=IdentityLayer(name + "_join")))
        else:
            for layer in layer_list:
                self.add_layer(layer)

    def __init__(self, name, num_classes=1000, width_mult=1.0, load_layers=True):
        super().__init__(name)
        if not load_layers:
            return
        in_ch = _make_divisible(16 * width_mult)
        self.add_layer(ConvLayer("stem", filter_block_shape=(in_ch, 3, 3, 3), stride=2,
                                 padding=1, with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("stem_bn", incoming_chans=in_ch))
        self.add_layer(HardSwish("stem_hswish"))
        for i, (k, exp, c, se, hs, s) in enumerate(self._CFG):
            out_ch = _make_divisible(c * width_mult)
            exp_ch = _make_divisible(exp * width_mult)
            self._bneck("bneck{}".format(i), in_ch, k, exp_ch, out_ch, se, hs, s)
            in_ch = out_ch
        last_conv = _make_divisible(self._HEAD_CONV * width_mult)
        self.add_layer(PointwiseConvLayer("head", filter_block_shape=(last_conv, in_ch),
                                          with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("head_bn", incoming_chans=last_conv))
        self.add_layer(HardSwish("head_hswish"))
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(DenseLayer("head_fc", incoming_chans=last_conv, output_dim=self._FC_DIM,
                                  weight_regulariser=l2(0.0001)))
        self.add_layer(HardSwish("head_fc_hswish"))
        self.add_layer(DenseLayer("classifier", incoming_chans=self._FC_DIM,
                                  output_dim=num_classes, weight_regulariser=l2(0.0001)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))


class MobileNetV3Small(_MobileNetV3):
    """11 bnecks, a 576-channel head conv and a 1024-wide classifier stage."""

    _CFG = [
        (3, 16, 16, True, False, 2),
        (3, 72, 24, False, False, 2),
        (3, 88, 24, False, False, 1),
        (5, 96, 40, True, True, 2),
        (5, 240, 40, True, True, 1),
        (5, 240, 40, True, True, 1),
        (5, 120, 48, True, True, 1),
        (5, 144, 48, True, True, 1),
        (5, 288, 96, True, True, 2),
        (5, 576, 96, True, True, 1),
        (5, 576, 96, True, True, 1),
    ]
    _HEAD_CONV = 576
    _FC_DIM = 1024


class MobileNetV3Large(_MobileNetV3):
    """15 bnecks (the first without an expansion, since exp == in_ch), a
    960-channel head conv and a 1280-wide classifier stage."""

    _CFG = [
        (3, 16, 16, False, False, 1),
        (3, 64, 24, False, False, 2),
        (3, 72, 24, False, False, 1),
        (5, 72, 40, True, False, 2),
        (5, 120, 40, True, False, 1),
        (5, 120, 40, True, False, 1),
        (3, 240, 80, False, True, 2),
        (3, 200, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 480, 112, True, True, 1),
        (3, 672, 112, True, True, 1),
        (5, 672, 160, True, True, 2),
        (5, 960, 160, True, True, 1),
        (5, 960, 160, True, True, 1),
    ]
    _HEAD_CONV = 960
    _FC_DIM = 1280
