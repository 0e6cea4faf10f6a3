"""Seeded random weights at the scale a trained network would have.

A forward on the constructors' 0.01*randn weights is near-uniform, and one
on He-normal weights with arbitrary BN statistics grows about threefold per
residual block; either way a top-1 or parity check on the output means
little. ``seed_serving_weights`` draws, from one numpy seed:

- He-normal weights (std sqrt(2/fan_in)) and biases 0.1*N(0,1), the
  squeeze-excite layers' two FCs included (fan-in C for ``w_reduce``, Cr
  for ``w_expand``), in each layer's parameter order;
- BN gamma 1 and beta 0.1*N(0,1);
- BN running_mean 0.1*N(0,1) and running_std U(0.5,1.5) times the std of
  that BN's input on a seeded calibration batch, as a trained network's
  running statistics track its activations.

That keeps activations of order one through the network (a squeeze-excite
gate left at its glorot init sits near 0.5 in every block of a deep
MobileNet-V3). A network without squeeze-excite layers draws what it drew
before they existed.
``gather_params()``/``gather_states()`` then carry the same values to
another network (a CPU twin, or the JAX package's in the parity tests).
"""

import numpy as np
import torch

from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DenseLayer,
                                      DepthwiseConvLayer, PointwiseConvLayer,
                                      ResidualBlock, SqueezeExciteLayer)
from dorknet_tpu_torch.layers.base import copy_into, to_nhwc


def _fan_in(layer):
    if isinstance(layer, ConvLayer):
        return layer.filter_chans * layer.f_rows * layer.f_cols
    if isinstance(layer, DepthwiseConvLayer):
        return layer.f_rows * layer.f_cols
    if isinstance(layer, PointwiseConvLayer):
        return layer.num_channels
    return layer.incoming_chans  # DenseLayer


def _calibrate(layer, x, rng):
    """``layer.fapply(x)``, setting each BN's running stats from the input
    it sees on the way."""
    if isinstance(layer, ResidualBlock):
        h = x
        for child in layer.layer_list:
            h = _calibrate(child, h, rng)
        skip = x
        if layer.skip_projection is not None:
            skip = _calibrate(layer.skip_projection, x, rng)
        return _calibrate(layer.post_skip_activation, h + skip, rng)
    if isinstance(layer, BatchNormLayer):
        shape = layer.gamma.shape
        scale = float(x.float().std())
        layer.set_state({"running_mean": 0.1 * rng.randn(*shape),
                         "running_std": scale * rng.uniform(0.5, 1.5, size=shape)})
    return layer.fapply(x)


def seed_serving_weights(net, seed, calib_hw):
    """Overwrite every parameter and running stat of ``net`` in place from
    ``np.random.RandomState(seed)``; the calibration batch is two seeded
    3-channel images of ``calib_hw``."""
    rng = np.random.RandomState(seed)
    for layer in net.modules():
        if isinstance(layer, (ConvLayer, DepthwiseConvLayer, PointwiseConvLayer,
                              DenseLayer)):
            w = layer.weights
            copy_into(w, rng.randn(*w.shape) * np.sqrt(2.0 / _fan_in(layer)),
                      layer.layer_name + "/weights")
            if layer.with_bias:
                copy_into(layer.bias, 0.1 * rng.randn(*layer.bias.shape),
                          layer.layer_name + "/bias")
        elif isinstance(layer, BatchNormLayer):
            copy_into(layer.gamma, np.ones(layer.gamma.shape),
                      layer.layer_name + "/gamma")
            copy_into(layer.beta, 0.1 * rng.randn(*layer.beta.shape),
                      layer.layer_name + "/beta")
        elif isinstance(layer, SqueezeExciteLayer):
            for w, b, fan_in in (("w_reduce", "b_reduce", layer.incoming_chans),
                                 ("w_expand", "b_expand", layer.reduced_chans)):
                p = getattr(layer, w)
                copy_into(p, rng.randn(*p.shape) * np.sqrt(2.0 / fan_in),
                          layer.layer_name + "/" + w)
                p = getattr(layer, b)
                copy_into(p, 0.1 * rng.randn(*p.shape), layer.layer_name + "/" + b)
    X = rng.randn(2, 3, *calib_hw).astype(np.float32)
    with torch.no_grad():  # not inference_mode: set_state makes the buffers here
        x = to_nhwc(torch.from_numpy(X).to(net.device()))
        for layer in net.layers:
            x = _calibrate(layer, x, rng)
