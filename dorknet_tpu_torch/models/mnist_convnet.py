"""The 5-conv MNIST network (counterpart of
``dorknet_tpu/models/mnist_convnet.py``), as the reference example
(examples/MNIST_basic_convnet.py:16-72) builds it: five Conv-BN-ReLU stages
(strides 1,1,2,1,2; 3x3 kernels, 4x4 at the strided stages), GAP, Dense(10),
softmax-CE, l2 1e-4 on the convs and 5e-4 on the classifier. The same
``np.random.seed`` builds the JAX package's weights bit for bit."""

from dorknet_tpu_torch.layers import (
    BatchNormLayer, ConvLayer, DenseLayer, GlobalAveragePoolingLayer, ReLu,
    SoftmaxWithCrossEntropy,
)
from dorknet_tpu_torch.network import FeedForwardNetwork
from dorknet_tpu_torch.regularisers.l2 import l2

# (out_channels, in_channels, kernel, stride): spatial 28→28→28→14→14→7
_STAGES = [
    (32, 1, 3, 1),
    (32, 32, 3, 1),
    (64, 32, 4, 2),
    (64, 64, 3, 1),
    (128, 64, 4, 2),
]


class MNISTNet(FeedForwardNetwork):
    def __init__(self, name, load_layers=True):
        super().__init__(name)
        if not load_layers:
            return
        for i, (out_ch, in_ch, k, stride) in enumerate(_STAGES, start=1):
            self.add_layer(ConvLayer(
                "conv_{}".format(i), filter_block_shape=(out_ch, in_ch, k, k),
                stride=stride, with_bias=False, weight_regulariser=l2(0.0001)))
            self.add_layer(BatchNormLayer("bn_{}".format(i), incoming_chans=out_ch))
            self.add_layer(ReLu("relu_{}".format(i)))
        self.add_layer(GlobalAveragePoolingLayer("global_pool"))
        self.add_layer(DenseLayer("dense_1", incoming_chans=128, output_dim=10,
                                  weight_regulariser=l2(0.0005)))
        self.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))
