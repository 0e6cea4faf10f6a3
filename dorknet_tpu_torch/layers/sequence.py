"""A list of layers run in order (``FeedForwardNetwork``'s layers, a
``ResidualBlock``'s ``layer_list``), with a train-mode batch norm and the
activation right after it as one call.

In train mode a ``BatchNormLayer`` immediately followed by a ``ReLu`` or a
``HardSwish`` (by type, not by subclass) runs as ``bn.fapply(x, True,
act=...)``: the batch norm's kernels apply the activation and its gradient
(``ops/cuda/bn_train.py``), the forward bit-equal to the two layers one
after the other, and the activation layer's own ``fapply`` is not called.
Every other layer and pairing, and every layer in test mode, runs its own
``fapply``. Parameters, state, grads and checkpoints are the layers' own:
nothing of the pairing is stored.

``run_layers.fused`` counts the pairs run fused, by activation;
``run_layers.unfused`` the train-mode batch norms followed by another
activation layer (``ReLu6``, ``HardSigmoid``, ``IdentityLayer``), which run
one after the other.
"""

import functools

from dorknet_tpu_torch.layers.activations import (HardSigmoid, HardSwish, IdentityLayer, ReLu,
                                                  ReLu6)
from dorknet_tpu_torch.layers.batch_norm import BatchNormLayer

# the activation layers a batch norm's kernels apply, by their act name
FUSED_ACTS = {ReLu: "relu", HardSwish: "hswish"}
_ACTIVATIONS = (ReLu, ReLu6, HardSwish, HardSigmoid, IdentityLayer)


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


def run_layers(layers, x, train=False, layer_wrap=None):
    """x through each of ``layers`` in order (``fapply(x, train)``), a
    train-mode batch norm and the ReLU or hard-swish after it as one call.
    ``layer_wrap(layer, apply)`` may return a transformed apply (the
    trainer's per-block rematerialisation); a fused pair is wrapped as its
    batch norm."""
    layers = list(layers)
    i = 0
    while i < len(layers):
        layer = layers[i]
        act = _pair_act(layer, layers[i + 1] if i + 1 < len(layers) else None) if train else None
        if act is None:
            apply, i = layer.fapply, i + 1
        else:
            apply, i = functools.partial(layer.fapply, act=act), i + 2
        if layer_wrap is not None:
            apply = layer_wrap(layer, apply)
        x = apply(x, train)
    return x


run_layers.fused = dict.fromkeys(FUSED_ACTS.values(), 0)
run_layers.unfused = 0
