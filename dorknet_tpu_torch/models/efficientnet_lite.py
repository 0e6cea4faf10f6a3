"""EfficientNet-Lite (counterpart of ``dorknet_tpu/models/efficientnet_lite.py``):
EfficientNet-B0's MBConv trunk with the lite rules (no squeeze-excite,
ReLU6 for swish, stem and head channels and the first and last stages'
repeats exempt from scaling). Each MBConv is MobileNet-V2's linear
bottleneck (``add_inverted_residual``) with a 3x3 or 5x5 depthwise layer;
the 3x3 ones take the hand-written kernels, the 5x5 ones
``F.conv2d(groups=C)``. Layer names and construction order are the JAX
package's."""

import math

from dorknet_tpu_torch.layers import (
    BatchNormLayer, ConvLayer, DenseLayer, GlobalAveragePoolingLayer, PointwiseConvLayer, ReLu6,
    SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.models.mobilenet_v2 import _make_divisible, add_inverted_residual
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2


class EfficientNetLite(FeedForwardNetwork):
    # (kernel k, expansion t, out channels c, repeats n, first stride s): B0
    _CFG = [
        (3, 1, 16, 1, 1),
        (3, 6, 24, 2, 2),
        (5, 6, 40, 2, 2),
        (3, 6, 80, 3, 2),
        (5, 6, 112, 3, 1),
        (5, 6, 192, 4, 2),
        (3, 6, 320, 1, 1),
    ]

    def __init__(self, name, num_classes=1000, width_mult=1.0, depth_mult=1.0,
                 load_layers=True):
        """lite0 = (1.0, 1.0); lite1 (1.0, 1.1); lite2 (1.1, 1.2); lite3
        (1.2, 1.4); lite4 (1.4, 1.8)."""
        super().__init__(name)
        if not load_layers:
            return
        in_ch = 32  # lite rule: the stem is not width-scaled
        self.add_layer(ConvLayer("stem", filter_block_shape=(in_ch, 3, 3, 3), stride=2,
                                 padding=1, with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("stem_bn", incoming_chans=in_ch))
        self.add_layer(ReLu6("stem_relu6"))
        block = 0
        n_stages = len(self._CFG)
        for stage, (k, t, c, n, s) in enumerate(self._CFG):
            out_ch = _make_divisible(c * width_mult)
            # lite rule: the first and last stages' repeats are not depth-scaled
            reps = n if stage in (0, n_stages - 1) else int(math.ceil(n * depth_mult))
            for i in range(reps):
                add_inverted_residual(self, "mb{}".format(block), in_ch, out_ch,
                                      s if i == 0 else 1, t, kernel=k)
                in_ch = out_ch
                block += 1
        last = 1280  # lite rule: the head is not width-scaled
        self.add_layer(PointwiseConvLayer("head", filter_block_shape=(last, in_ch),
                                          with_bias=False, weight_regulariser=l2(0.0001)))
        self.add_layer(BatchNormLayer("head_bn", incoming_chans=last))
        self.add_layer(ReLu6("head_relu6"))
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(DenseLayer("classifier", incoming_chans=last, output_dim=num_classes,
                                  weight_regulariser=l2(0.0001)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))


def EfficientNetLite0(name, num_classes=1000, load_layers=True):
    return EfficientNetLite(name, num_classes=num_classes, width_mult=1.0, depth_mult=1.0,
                            load_layers=load_layers)
