"""A list of layers run in order (``FeedForwardNetwork``'s layers, a
``ResidualBlock``'s ``layer_list``), with a layer and the activation right
after it as one call: in train mode a batch norm's, in test mode a biased
conv's or dense layer's.

In train mode a ``BatchNormLayer`` immediately followed by a ``ReLu`` or a
``HardSwish`` (by type, not by subclass) runs as ``bn.fapply(x, True,
act=...)``: the batch norm's kernels apply the activation and its gradient
(``ops/cuda/bn_train.py``), the forward bit-equal to the two layers one
after the other, and the activation layer's own ``fapply`` is not called.

In test mode a ``ConvLayer``, ``DepthwiseConvLayer``, ``PointwiseConvLayer``
or ``DenseLayer`` (by type) with a bias runs as ``layer.fapply(x, False,
act=...)``: with ``act="relu"`` or ``"hswish"`` when a ``ReLu`` or a
``HardSwish`` follows it, which is then not called, else ``act="none"``. Its
op adds the bias and applies the activation in one pass, ``bias_act``,
where no gradient is needed (``ops/conv.py``), bit-equal to the layers one
after the other.

Every other layer and pairing runs its own ``fapply``. Parameters, state,
grads and checkpoints are the layers' own: nothing of the pairing is
stored.

``run_layers.fused`` counts the train-mode pairs run fused, by activation;
``run_layers.unfused`` the train-mode batch norms followed by another
activation layer (``ReLu6``, ``HardSigmoid``, ``IdentityLayer``), which run
one after the other. ``run_layers.fused_bias`` counts the test-mode biased
layers by the act they run with; ``run_layers.unfused_bias`` those followed
by a ``ReLu6`` or a ``HardSigmoid``, which run with ``act="none"`` and then
the activation layer.
"""

import functools

from dorknet_tpu_torch.layers.activations import (HardSigmoid, HardSwish, IdentityLayer, ReLu,
                                                  ReLu6)
from dorknet_tpu_torch.layers.batch_norm import BatchNormLayer
from dorknet_tpu_torch.layers.convolution import ConvLayer
from dorknet_tpu_torch.layers.dense_layer import DenseLayer
from dorknet_tpu_torch.layers.depthwise_convolution import DepthwiseConvLayer
from dorknet_tpu_torch.layers.pointwise_convolution import PointwiseConvLayer

# the activation layers a batch norm's kernels, or the bias pass, apply, by
# their act name
FUSED_ACTS = {ReLu: "relu", HardSwish: "hswish"}
_ACTIVATIONS = (ReLu, ReLu6, HardSwish, HardSigmoid, IdentityLayer)
# the layers whose bias the bias pass adds in test mode
BIASED = (ConvLayer, DepthwiseConvLayer, PointwiseConvLayer, DenseLayer)


def _pair_act(layer, nxt):
    """The act with which train-mode ``layer`` and ``nxt`` run as one call,
    or None; counts the pair, fused or not."""
    if type(layer) is not BatchNormLayer:
        return None
    act = FUSED_ACTS.get(type(nxt))
    if act is not None:
        run_layers.fused[act] += 1
    elif isinstance(nxt, _ACTIVATIONS):
        run_layers.unfused += 1
    return act


def _bias_act(layer, nxt):
    """The act with which test-mode ``layer`` runs, consuming ``nxt`` unless
    it is "none", or None for a layer without a bias pass; counts it."""
    if type(layer) not in BIASED or not layer.with_bias:
        return None
    act = FUSED_ACTS.get(type(nxt), "none")
    if isinstance(nxt, (ReLu6, HardSigmoid)):
        run_layers.unfused_bias += 1
    run_layers.fused_bias[act] += 1
    return act


def run_layers(layers, x, train=False, layer_wrap=None):
    """x through each of ``layers`` in order (``fapply(x, train)``), a
    train-mode batch norm and the ReLU or hard-swish after it as one call,
    and a test-mode biased layer with its bias pass and the ReLU or
    hard-swish after it as one call. ``layer_wrap(layer, apply)`` may return
    a transformed apply (the trainer's per-block rematerialisation); a fused
    pair is wrapped as its first layer."""
    layers = list(layers)
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        act = _pair_act(layer, nxt) if train else _bias_act(layer, nxt)
        if act is None:
            apply, i = layer.fapply, i + 1
        else:
            apply = functools.partial(layer.fapply, act=act)
            i += 1 if act == "none" else 2
        if layer_wrap is not None:
            apply = layer_wrap(layer, apply)
        x = apply(x, train)
    return x


run_layers.fused = dict.fromkeys(FUSED_ACTS.values(), 0)
run_layers.unfused = 0
run_layers.fused_bias = dict.fromkeys(("none",) + tuple(FUSED_ACTS.values()), 0)
run_layers.unfused_bias = 0
