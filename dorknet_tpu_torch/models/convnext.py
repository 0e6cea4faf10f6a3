"""ConvNeXt (Liu et al. 2022, "A ConvNet for the 2020s", arXiv:2201.03545;
the published ``convnext_tiny`` of github.com/facebookresearch/ConvNeXt),
the port's own: the JAX package has no LayerNorm, GELU or layer scale.

A 4x4/s4 stem conv with bias and a LayerNorm; four stages of ``depths``
blocks at ``dims`` channels, each stage after the first entered through a
LayerNorm and a 2x2/s2 conv with bias; then global average pooling, a
LayerNorm and the dense classifier. Each block is a ``ResidualBlock`` with
an identity skip and a linear join (``IdentityLayer``) around

    7x7 depthwise conv with bias (padding 3), LayerNorm, pointwise conv to
    4C with bias, GELU (exact erf), pointwise conv back to C with bias,
    layer scale.

Every LayerNorm normalises over the channels with ``ln_eps``. ConvNeXt-T,
the defaults: 28,589,128 parameters at 1,000 classes, 18 blocks, 23
LayerNorms and no batch norm. No weight carries a regulariser: AdamW
decays the weights (``optimisers/AdamW.py``). The published model's
stochastic depth (drop path 0.1 for ConvNeXt-T) is not built.

Layer names, by ``<layer>/<parameter>``: ``stem``, ``stem_ln``;
``down<i>_ln``, ``down<i>`` (stages i = 2, 3, 4); ``s<i>b<j>_dw``,
``_ln``, ``_pw1``, ``_gelu``, ``_pw2``, ``_scale`` in block ``s<i>b<j>``
(``_join`` its join); ``global_pool``, ``head_ln``, ``classifier``.

The constructors' weights are the port's "normal" init (0.01 N(0, 1)) with
zero biases, LayerNorm gains 1 and offsets 0, and layer scales 1e-6 as
published (the published weights are truncated-normal 0.02)."""

from dorknet_tpu_torch.layers import (
    GELU, ConvLayer, DenseLayer, DepthwiseConvLayer, GlobalAveragePoolingLayer, IdentityLayer,
    LayerNormLayer, LayerScale, PointwiseConvLayer, ResidualBlock, SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.network import FeedForwardNetwork


class ConvNeXt(FeedForwardNetwork):
    def __init__(self, name, num_classes=1000, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 ln_eps=1e-6):
        super().__init__(name)
        if len(depths) != len(dims):
            raise ValueError("ConvNeXt needs one depth a stage: depths {}, dims {}".format(
                depths, dims))
        self.add_layer(ConvLayer("stem", filter_block_shape=(dims[0], 3, 4, 4), stride=4,
                                 padding=0))
        self.add_layer(LayerNormLayer("stem_ln", dims[0], ln_eps))
        for i, (depth, dim) in enumerate(zip(depths, dims), start=1):
            if i > 1:
                self.add_layer(LayerNormLayer("down{}_ln".format(i), dims[i - 2], ln_eps))
                self.add_layer(ConvLayer("down{}".format(i),
                                         filter_block_shape=(dim, dims[i - 2], 2, 2), stride=2,
                                         padding=0))
            for j in range(depth):
                self._block("s{}b{}".format(i, j), dim, ln_eps)
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(LayerNormLayer("head_ln", dims[-1], ln_eps))
        self.add_layer(DenseLayer("classifier", incoming_chans=dims[-1], output_dim=num_classes))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))

    def _block(self, name, dim, ln_eps):
        layer_list = [
            DepthwiseConvLayer(name + "_dw", filter_block_shape=(dim, 7, 7), padding=3),
            LayerNormLayer(name + "_ln", dim, ln_eps),
            PointwiseConvLayer(name + "_pw1", filter_block_shape=(4 * dim, dim)),
            GELU(name + "_gelu"),
            PointwiseConvLayer(name + "_pw2", filter_block_shape=(dim, 4 * dim)),
            LayerScale(name + "_scale", dim),
        ]
        self.add_layer(ResidualBlock(name, layer_list=layer_list,
                                     post_skip_activation=IdentityLayer(name + "_join")))
