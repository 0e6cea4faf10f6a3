"""ResNet-18-depsep, the flagship (counterpart of ``dorknet_tpu/models/resnet.py``).

A 5x5/s2 stem conv and a strided pointwise ``pw0``, eight
depthwise-separable residual blocks (64→512, downsampling at blocks 3/5/7
through a stride-2 depthwise and a pointwise skip projection), global
average pooling and a dense classifier. Layer names and construction order
are the JAX package's, so the same ``np.random.seed`` builds bit-equal
weights and the reference's checkpoints load by name.
"""

from dorknet_tpu_torch.layers import (
    ConvLayer, DepthwiseConvLayer, PointwiseConvLayer, DenseLayer,
    BatchNormLayer, ReLu, GlobalAveragePoolingLayer, ResidualBlock,
    SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2


class ResNet18(FeedForwardNetwork):
    def depthwise_sep_layer(self, layer_name, incoming_chans, filter_block_shape,
                            stride=1, padding=1, with_bias=False,
                            pointwise_weight_regulariser=None, final_relu=True):
        """filter_block_shape: (outgoing_chans, incoming_chans, f_rows, f_cols).
        Returns [depthwise, BN, pointwise, BN(, ReLu)]."""
        layer_list = [
            DepthwiseConvLayer(layer_name + "_dw",
                               filter_block_shape=(incoming_chans,
                                                   filter_block_shape[-2],
                                                   filter_block_shape[-1]),
                               stride=stride, padding=padding, with_bias=with_bias),
            BatchNormLayer(layer_name + "_dw_bn", input_dimension=4,
                           incoming_chans=incoming_chans),
            PointwiseConvLayer(layer_name + "_pw",
                               filter_block_shape=(filter_block_shape[0], incoming_chans),
                               with_bias=with_bias,
                               weight_regulariser=pointwise_weight_regulariser),
            BatchNormLayer(layer_name + "_pw_bn", input_dimension=4,
                           incoming_chans=filter_block_shape[0]),
        ]
        if final_relu:
            layer_list.append(ReLu(layer_name + "pw_relu"))
        return layer_list

    def add_res_block(self, layer_name, first_filter_block_shape, downsample=False,
                      weight_regulariser_strength=0.0001):
        num_filters, incoming_chans, f_rows, f_cols = first_filter_block_shape
        layer_list = self.depthwise_sep_layer(
            layer_name + "_dw1", incoming_chans, first_filter_block_shape,
            stride=2 if downsample else 1, padding=1,
            pointwise_weight_regulariser=l2(strength=weight_regulariser_strength),
            final_relu=True)
        layer_list += self.depthwise_sep_layer(
            layer_name + "_dw2", num_filters,
            (num_filters, num_filters, f_rows, f_cols), stride=1, padding=1,
            pointwise_weight_regulariser=l2(strength=weight_regulariser_strength),
            final_relu=False)
        skip_proj = None
        if downsample:
            skip_proj = PointwiseConvLayer(
                layer_name + "_pw_skip", filter_block_shape=(num_filters, incoming_chans),
                stride=2, with_bias=False,
                weight_regulariser=l2(strength=weight_regulariser_strength))
        self.add_layer(ResidualBlock(layer_name, layer_list=layer_list,
                                     skip_projection=skip_proj,
                                     post_skip_activation=ReLu(layer_name + "_relu2")))

    # residual stage table: (out_channels, in_channels, downsample)
    # spatial: 225 →(stem/2)→ 112 →(pw0/2)→ 56 → 56 → 28 → 28 → 14 → 14 → 7 → 7
    _BLOCKS = [
        (64, 64, False), (64, 64, False),
        (128, 64, True), (128, 128, False),
        (256, 128, True), (256, 256, False),
        (512, 256, True), (512, 512, False),
    ]

    def __init__(self, name, load_layers=True, num_classes=120):
        super().__init__(name)
        if not load_layers:
            return
        self.add_layer(ConvLayer("conv0", filter_block_shape=(64, 3, 5, 5),
                                 with_bias=False, stride=2, padding=1,
                                 weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("conv0_bn", input_dimension=4,
                                      incoming_chans=64))
        self.add_layer(ReLu("conv0_relu"))
        self.add_layer(PointwiseConvLayer("pw0", filter_block_shape=(64, 64),
                                          with_bias=False, stride=2,
                                          weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("pw0_bn", input_dimension=4,
                                      incoming_chans=64))
        self.add_layer(ReLu("pw0_relu"))
        for i, (out_ch, in_ch, down) in enumerate(self._BLOCKS, start=1):
            self.add_res_block("res{}".format(i), (out_ch, in_ch, 3, 3),
                               downsample=down)
        self.add_layer(GlobalAveragePoolingLayer("global_pool1"))
        self.add_layer(DenseLayer("dense1", incoming_chans=512,
                                  output_dim=num_classes,
                                  weight_regulariser=l2(0.0001)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax1"))
