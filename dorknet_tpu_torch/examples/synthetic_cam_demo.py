"""Self-contained CAM demo, no dataset needed (the twin of
``examples/synthetic_cam_demo.py``).

Trains a small convnet for 60 ``Trainer.step``s on synthetic images whose
class is the colour of a bright blob at a random place, then renders Class
Activation Map overlays with ``dorknet_tpu_torch.cam`` and the JET colormap
and PNG writer of ``utils/render.py`` (the JAX demo draws with cv2). The same
data, network, seeds, overlay arithmetic and file names as the JAX demo.
The run is on the card; ``DORKNET_DEVICE=cpu`` is for the tests.

Run:  python -m dorknet_tpu_torch.examples.synthetic_cam_demo [out_dir]
"""

import os
import sys

import numpy as np

from dorknet_tpu_torch.cam import compute_cam_scores
from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DenseLayer,
                                      GlobalAveragePoolingLayer, ReLu, SoftmaxWithCrossEntropy)
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer
from dorknet_tpu_torch.optimisers import SGDMomentum
from dorknet_tpu_torch.utils.render import apply_jet, write_png

DEVICE = os.environ.get("DORKNET_DEVICE", "cuda")

# class = blob COLOUR (appearance survives global average pooling; position is
# random, so the CAM should light up wherever the blob landed)
CLASS_BGR = {0: (110.0, 0.0, 0.0), 1: (0.0, 110.0, 0.0),
             2: (0.0, 0.0, 110.0), 3: (80.0, 80.0, 0.0)}


def make_batch(rng, B=32, size=64):
    y = rng.randint(0, 4, B)
    X = rng.randn(B, 3, size, size).astype(np.float32) * 8.0 + 128.0
    yy, xx = np.mgrid[0:size, 0:size]
    for i, yi in enumerate(y):
        cy, cx = rng.randint(12, size - 12, 2)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 6.0 ** 2)))
        for ch, amp in enumerate(CLASS_BGR[yi]):
            X[i, ch] += amp * blob
    X = np.clip(X, 0, 255) - 128.0
    return X, y, np.eye(4, dtype=np.float32)[y]


def build_net():
    net = FeedForwardNetwork("synthetic-cam")
    net.add_layer(ConvLayer("conv1", filter_block_shape=(16, 3, 3, 3), with_bias=False))
    net.add_layer(BatchNormLayer("bn1", incoming_chans=16))
    net.add_layer(ReLu("relu1"))
    net.add_layer(ConvLayer("conv2", filter_block_shape=(32, 16, 3, 3), stride=2,
                            with_bias=False))
    net.add_layer(BatchNormLayer("bn2", incoming_chans=32))
    net.add_layer(ReLu("features"))  # CAM tap point
    net.add_layer(GlobalAveragePoolingLayer("gap"))
    net.add_layer(DenseLayer("dense1", incoming_chans=32, output_dim=4))
    net.set_loss_layer(SoftmaxWithCrossEntropy("softmax"))
    return net


def main(out_dir="CAM_outputs/synthetic", steps=60, seed=0):
    rng = np.random.RandomState(seed)
    np.random.seed(seed)
    net = build_net()
    tr = Trainer(net, SGDMomentum(net, 0.05, 0.9), device=DEVICE)
    for i in range(steps):
        X, y, oh = make_batch(rng)
        loss, _ = tr.step(X, oh)
        if i % 20 == 0:
            print("step {} loss {:.4f}".format(i, float(loss)))

    os.makedirs(out_dir, exist_ok=True)
    X, y, _ = make_batch(rng, B=4)
    correct = 0
    for i in range(4):
        scores, cams = compute_cam_scores(net, X[i:i + 1], top_k=1,
                                          terminal_layer_name="features", out_size=64)
        scores, cams = scores.cpu().numpy(), cams.cpu().numpy()
        pred = int(np.argmax(scores))
        correct += int(pred == y[i])
        img = (X[i].transpose(1, 2, 0) + 128.0).astype(np.uint8)
        heat = apply_jet(np.uint8(255 * cams[0])).astype(np.float32)
        overlay = heat + img.astype(np.float32)
        overlay = np.uint8(255 * overlay / overlay.max())
        path = os.path.join(out_dir, "img{}_true{}_pred{}.png".format(i, y[i], pred))
        write_png(path, overlay)
        print("wrote", path)
    print("accuracy on demo images: {}/4".format(correct))
    return correct


if __name__ == "__main__":
    main(*(sys.argv[1:2] or []))
