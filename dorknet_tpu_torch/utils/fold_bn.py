"""Batch-norm folding for inference (counterpart of
``dorknet_tpu/utils/fold_bn.py``).

At test time BN is an affine map by frozen running stats (y = gamma*(x -
mean)/std + beta), so a conv→BN pair collapses into the conv: W' = W *
(gamma/std) per output channel, b' = beta + (b - mean) * (gamma/std). Folding
removes BN's passes over every activation it normalises.

``fold_batch_norms(network)`` returns a new network (the original is
untouched) with every Conv/Depthwise/Pointwise + BatchNorm pair folded,
pairs inside ResidualBlocks included, and a block's skip projection with
its ``skip_bn`` (the block loses its ``skip_bn``). A BN that is not
initialised, or does not follow a foldable conv, stays. The fold runs in
fp32 with the JAX package's operations in its order, so the folded weights
are bit-equal to its ``fold_batch_norms``'s. A conv built without a bias gains one, a real
``nn.Parameter``.

``refold(served, source)`` writes the fold of ``source``'s current
parameters and running statistics into a network that was folded from it
earlier, in place: ``InferenceRunner.refresh()`` of a folded runner.

The JAX module also drops per-layer jit caches before copying
(``_clear_jit_caches``); the port keeps no jit caches, so it has no
counterpart.
"""

import torch
from torch import nn

_FOLDABLE = ("ConvLayer", "DepthwiseConvLayer", "PointwiseConvLayer")


def _folded(conv, bn):
    """(W', b') of ``conv`` followed by ``bn``, new fp32 tensors on the
    conv's device."""
    with torch.no_grad():
        gamma = bn.gamma.reshape(-1)
        beta = bn.beta.reshape(-1)
        mean = bn.running_mean.reshape(-1)
        std = bn.running_std.reshape(-1)
        scale = gamma / std  # (out_channels,)
        # ConvLayer (O, I, fh, fw), DepthwiseConvLayer (C, fh, fw),
        # PointwiseConvLayer (O, C): the output channel leads each
        w = conv.weights * scale.reshape((-1,) + (1,) * (conv.weights.dim() - 1))
        b = conv.bias if conv.with_bias else torch.zeros_like(mean)
        b = beta + (b - mean) * scale
    return w, b


def _scale_into(conv, bn):
    w, b = _folded(conv, bn)
    conv.weights = nn.Parameter(w, requires_grad=conv.weights.requires_grad)
    conv.bias = nn.Parameter(b, requires_grad=conv.weights.requires_grad)
    conv.with_bias = True


def _pairs(layers):
    """(layer, the BN folded into it or None) over a layer list, in order."""
    i = 0
    while i < len(layers):
        l = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (type(l).__name__ in _FOLDABLE and nxt is not None
                and type(nxt).__name__ == "BatchNormLayer"
                and nxt.bn_initialized()):
            yield l, nxt
            i += 2
        else:
            yield l, None
            i += 1


def _fold_list(layers):
    """Fold conv→BN pairs in a layer list (in place); returns the new list."""
    out = []
    for l, bn in _pairs(layers):
        if bn is not None:
            _scale_into(l, bn)
        elif type(l).__name__ == "ResidualBlock":
            l.layer_list = nn.ModuleList(_fold_list(list(l.layer_list)))
            if l.skip_bn is not None and l.skip_bn.bn_initialized():
                _scale_into(l.skip_projection, l.skip_bn)
                l.skip_bn = None
        out.append(l)
    return out


def fold_in_place(network):
    """Fold ``network``'s own conv→BN pairs; returns it."""
    network.layers = nn.ModuleList(_fold_list(list(network.layers)))
    network.name = network.name + "_bnfolded"
    return network


def fold_batch_norms(network):
    """A copy of ``network`` on its device with conv→BN pairs folded."""
    from dorknet_tpu_torch.network.inference import _snapshot

    return fold_in_place(_snapshot(network, network.device()))


def _copy_tensors(dst, src):
    for d, s in zip(list(dst.parameters()) + list(dst.buffers()),
                    list(src.parameters()) + list(src.buffers()), strict=True):
        d.copy_(s)


def refold(served, source):
    """Write the fold of ``source``'s layers into ``served``, a folded copy of
    it (``fold_in_place``), in place: the source's conv→BN pairs are walked in
    the order ``_fold_list`` walked them, nested ones included, and every
    other layer's parameters and buffers are copied."""
    with torch.no_grad():
        _refold_list(list(served.layers), list(source.layers))


def _refold_list(served, source):
    for dst, (src, bn) in zip(served, _pairs(source), strict=True):
        if bn is not None:
            w, b = _folded(src, bn)
            dst.weights.copy_(w)
            dst.bias.copy_(b)
        elif type(src).__name__ == "ResidualBlock":
            _refold_list(list(dst.layer_list), list(src.layer_list))
            pairs = [(dst.post_skip_activation, src.post_skip_activation)]
            if dst.skip_bn is None and src.skip_bn is not None:  # folded
                w, b = _folded(src.skip_projection, src.skip_bn)
                dst.skip_projection.weights.copy_(w)
                dst.skip_projection.bias.copy_(b)
            else:
                pairs += [(dst.skip_projection, src.skip_projection),
                          (dst.skip_bn, src.skip_bn)]
            for d, s in pairs:
                if s is not None:
                    _copy_tensors(d, s)
        else:
            _copy_tensors(dst, src)
