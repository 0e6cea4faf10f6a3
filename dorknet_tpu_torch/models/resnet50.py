"""ResNet-50 and ResNet-101 (counterpart of ``dorknet_tpu/models/resnet50.py``):
bottleneck blocks (a 1x1 reduce that subsamples first when strided, a 3x3
conv, a 1x1 expand, each with BN) with strided pointwise skip projections
(no BN), after a 7x7/s2 stem and a 2x2/s2 max pool (the zoo's
``MaxPoolLayer`` has a window equal to its stride, where the canonical
stem pools 3x3). No depthwise layer: the 3x3 convs are ``F.conv2d``, as the
JAX package leaves them to XLA. Layer names and construction order are the
JAX package's."""

from dorknet_tpu_torch.layers import (
    BatchNormLayer, ConvLayer, DenseLayer, GlobalAveragePoolingLayer, MaxPoolLayer,
    PointwiseConvLayer, ReLu, ResidualBlock, SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2


class ResNet50(FeedForwardNetwork):
    _STAGES = [  # (bottleneck width, out channels, blocks, first stride)
        (64, 256, 3, 1),
        (128, 512, 4, 2),
        (256, 1024, 6, 2),
        (512, 2048, 3, 2),
    ]

    def _bottleneck(self, name, in_ch, width, out_ch, stride, reg=0.0001):
        layer_list = [
            PointwiseConvLayer(name + "_reduce", filter_block_shape=(width, in_ch),
                               stride=stride, with_bias=False, weight_regulariser=l2(reg)),
            BatchNormLayer(name + "_reduce_bn", incoming_chans=width),
            ReLu(name + "_reduce_relu"),
            ConvLayer(name + "_conv3", filter_block_shape=(width, width, 3, 3), stride=1,
                      padding=1, with_bias=False, weight_regulariser=l2(reg)),
            BatchNormLayer(name + "_conv3_bn", incoming_chans=width),
            ReLu(name + "_conv3_relu"),
            PointwiseConvLayer(name + "_expand", filter_block_shape=(out_ch, width),
                               with_bias=False, weight_regulariser=l2(reg)),
            BatchNormLayer(name + "_expand_bn", incoming_chans=out_ch),
        ]
        skip = None
        if stride != 1 or in_ch != out_ch:
            skip = PointwiseConvLayer(name + "_skip", filter_block_shape=(out_ch, in_ch),
                                      stride=stride, with_bias=False,
                                      weight_regulariser=l2(reg))
        self.add_layer(ResidualBlock(name, layer_list=layer_list, skip_projection=skip,
                                     post_skip_activation=ReLu(name + "_relu")))

    def __init__(self, name, num_classes=1000, load_layers=True):
        super().__init__(name)
        if not load_layers:
            return
        self.add_layer(ConvLayer("stem", filter_block_shape=(64, 3, 7, 7), stride=2, padding=3,
                                 with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("stem_bn", incoming_chans=64))
        self.add_layer(ReLu("stem_relu"))
        self.add_layer(MaxPoolLayer("stem_pool", None, stride=2))
        in_ch = 64
        for si, (width, out_ch, blocks, stride) in enumerate(self._STAGES):
            for b in range(blocks):
                self._bottleneck("s{}b{}".format(si + 1, b), in_ch, width, out_ch,
                                 stride if b == 0 else 1)
                in_ch = out_ch
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(DenseLayer("classifier", incoming_chans=2048, output_dim=num_classes,
                                  weight_regulariser=l2(0.0001)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))


class ResNet101(ResNet50):
    """The ResNet-50 builder with 23 bottlenecks in the third stage (He et
    al., table 1)."""

    _STAGES = [
        (64, 256, 3, 1),
        (128, 512, 4, 2),
        (256, 1024, 23, 2),
        (512, 2048, 3, 2),
    ]
