"""Class Activation Maps and Grad-CAM (counterpart of ``dorknet_tpu/cam.py``).

The reference's CAM (examples/imagenet_dogs_225_resnet_18_depsep_CAM.py:13-89)
takes the class scores from a test-mode forward, taps the features with a
train-mode forward stopped at ``terminal_layer_name`` (batch statistics,
which also moved its running stats), projects the classifier's weights for
the top-k classes onto them, upsamples, applies ReLU and min-max normalises.
Here both forwards run eagerly on the network's device; the tap normalises
by batch statistics as the reference's does but moves no running stat
(``running_stats_frozen``). On the card the depthwise layers run the
hand-written forward kernel and the tap's batch norms the statistics kernel.

Every function returns torch tensors on the network's device (``returnCAM``,
the reference's host-side shim, returns numpy arrays). Maps are ordered by
descending class score; among equal scores the higher class index comes
first, as the JAX package's ``argsort(scores)[::-1]`` orders them. The
bilinear resize is ``jax.image.resize``'s: half-pixel centres upsampling,
a widened triangle kernel (antialiasing) downsampling.

Grad-CAM runs the trunk up to the tap in test mode without autograd, then
the rest of the network on the detached features with every later
parameter's ``requires_grad`` cleared, so the backward computes no weight
gradient: on the card a deep tap launches the depthwise dx kernel and never
the dw kernel.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.layers.batch_norm import running_stats_frozen
from dorknet_tpu_torch.network.feed_forward_network import _tap_index
from dorknet_tpu_torch.ops.loss import softmax_probs


def _classifier_weights(net):
    """The classifier's (C, num_classes) weights: those of the LAST
    DenseLayer (the reference reads its 'dense1' head). Matched by class,
    not by name."""
    dense_w = None
    for l in net.layers:
        if l.__class__.__name__ == "DenseLayer":
            dense_w = l.weights
    if dense_w is None:
        raise ValueError(
            "CAM needs a DenseLayer classifier head; network '{}' has none "
            "(layers: {})".format(net.name, [l.__class__.__name__ for l in net.layers]))
    return dense_w.detach()


def _top_k(scores, top_k):
    """(N, min(top_k, classes)) class ids by descending score; a stable
    ascending sort reversed, so among ties the higher index leads."""
    return torch.argsort(scores, dim=1, stable=True).flip(1)[:, :top_k]


def _resize(cam, size):
    """Bilinear resize of the last two axes of ``cam`` (…, h, w) to
    ``size`` (S, S) or (H, W): ``jax.image.resize(..., "bilinear")``."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    lead = cam.shape[:-2]
    x = cam.reshape(1, -1, *cam.shape[-2:])
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    y = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=down)
    return y.reshape(*lead, *size)


def _finish(cam, out_size):
    """(N, K, h, w) maps -> resized, ReLU'd and min-max normalised to [0, 1]
    (a map that is 0 everywhere stays 0)."""
    cam = torch.clamp(_resize(cam, out_size), min=0)
    cam = cam - cam.amin(dim=(2, 3), keepdim=True)
    mx = cam.amax(dim=(2, 3), keepdim=True)
    return torch.where(mx > 0, cam / mx, cam)


def _project(dense_w, scores, feats, top_k):
    """CAM's maps (N, K, h, w): the classifier's rows for each image's top
    classes dotted with its NHWC features. The classifier's rows must lie
    over the tap's channels: behind a two-stage head (MobileNet-V3's GAP,
    dense, hard-swish, dense) they lie over the hidden units, and CAM
    raises, as the JAX package's einsum does; Grad-CAM serves there."""
    if dense_w.shape[0] != feats.shape[-1]:
        raise ValueError(
            "CAM projects the classifier's {} input rows onto the tap's {} channels; they "
            "differ (a head with more than one dense layer?): use Grad-CAM".format(
                dense_w.shape[0], feats.shape[-1]))
    top = _top_k(scores, top_k)
    w_sel = dense_w.t()[top]  # (N, K, C)
    return torch.einsum("nkc,nhwc->nkhw", w_sel.float(), feats.float())


def _scores(net, x):
    """Test-mode softmax scores (N, classes) of NHWC x."""
    out, _, _ = net._run_layers(x)
    return softmax_probs(out)


def _tap(net, x, index):
    """The train-mode (batch-statistics) features of NHWC x at layer
    ``index``, moving no running stat."""
    with running_stats_frozen(net):
        return net._run_prefix(x, index, train=True)


def _prepare(net, X, what, terminal_layer_name):
    net._require_bn_initialized(what)
    index = _tap_index(net, terminal_layer_name)
    X = torch.as_tensor(X, dtype=torch.float32, device=net.device())
    return to_nhwc(X), index


def compute_cam_scores(net, X, top_k=3, terminal_layer_name="res8", out_size=225):
    """Returns (scores (num_classes,), cams (top_k, out_size, out_size)) for
    a single image batch X of shape (1, 3, H, W). The tap normalises by the
    statistics of X. cams are ReLU'd and min-max normalised to [0, 1],
    ordered by descending class score."""
    x, index = _prepare(net, X, "compute_cam_scores", terminal_layer_name)
    dense_w = _classifier_weights(net)
    with torch.no_grad():
        scores = _scores(net, x)[:1]
        feats = _tap(net, x, index)[:1]
        cam = _finish(_project(dense_w, scores, feats, top_k), out_size)
    return scores[0], cam[0]


def compute_cam_scores_batch(net, X, top_k=3, terminal_layer_name="res8", out_size=225):
    """Batched CAM. X (N,3,H,W). Returns (scores (N,num_classes), cams
    (N,top_k,S,S)), each image's maps ordered by its own descending class
    score. Each image's tap normalises by its own statistics, as the
    reference's per-image CAM does (a train-mode tap over all N at once
    would not): the tap runs once per image, the scores in one test-mode
    forward."""
    x, index = _prepare(net, X, "compute_cam_scores_batch", terminal_layer_name)
    dense_w = _classifier_weights(net)
    with torch.no_grad():
        scores = _scores(net, x)
        feats = torch.cat([_tap(net, x[i:i + 1], index) for i in range(x.shape[0])])
        cam = _finish(_project(dense_w, scores, feats, top_k), out_size)
    return scores, cam


@contextlib.contextmanager
def _no_weight_grads(layers):
    """Inside, no parameter of ``layers`` requires a gradient."""
    params = [p for l in layers for p in l.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def compute_gradcam_scores_batch(net, X, top_k=3, terminal_layer_name="res8", out_size=225):
    """Grad-CAM (Selvaraju et al. 2017), batched. Each channel of the tap is
    weighted by the spatial mean of d(class score)/d(activation), exact for
    any tap depth and head; at a tap that feeds GAP and a dense head it
    gives CAM's maps. Unlike CAM the whole network runs in test mode
    (running statistics). X (N,3,H,W). Returns (scores (N,num_classes),
    cams (N,top_k,S,S)), each image's maps ordered by its own descending
    class score, ReLU'd and min-max normalised to [0, 1]."""
    x, index = _prepare(net, X, "compute_gradcam_scores_batch", terminal_layer_name)
    with torch.no_grad():
        feats = net._run_prefix(x, index)
    feats = feats.detach().requires_grad_()
    rest = net.layers[index + 1:]
    with torch.enable_grad(), _no_weight_grads(rest):
        out = feats
        for l in rest:
            out = l.fapply(out)
        scores = softmax_probs(out.detach())
        top = _top_k(scores, top_k)
        maps = []
        for j in range(top.shape[1]):
            # image n's cotangent selects its own j-th class: the test-mode
            # network is batchwise independent, so this is each image's
            # d out[n, top[n, j]] / d feats[n]
            ct = torch.zeros_like(out).scatter_(1, top[:, j:j + 1], 1.0)
            dA, = torch.autograd.grad(out, feats, ct, retain_graph=j + 1 < top.shape[1])
            alpha = dA.float().mean(dim=(1, 2), keepdim=True)
            maps.append((alpha * feats.detach().float()).sum(dim=-1))
    with torch.no_grad():
        cam = _finish(torch.stack(maps, dim=1), out_size)
    return scores, cam


def compute_gradcam_scores(net, X, top_k=3, terminal_layer_name="res8", out_size=225):
    """Single-image Grad-CAM: X (1,3,H,W) -> (scores (num_classes,), cams
    (top_k, S, S)). See compute_gradcam_scores_batch."""
    scores, cams = compute_gradcam_scores_batch(
        net, X, top_k=top_k, terminal_layer_name=terminal_layer_name, out_size=out_size)
    return scores[0], cams[0]


def returnCAM(feature_conv, weight_softmax, class_idx, size_upsample=(225, 225)):
    """The reference's host-side ``returnCAM`` (CAM example :13-32):
    feature_conv (1,C,H,W) numpy, weight_softmax (num_classes, C), class_idx
    iterable. Returns a list of (H', W') float arrays."""
    bz, chans, height, width = feature_conv.shape
    output_cam = []
    for idx in class_idx:
        cam = weight_softmax[idx].dot(feature_conv.reshape(chans, height * width))
        cam = torch.from_numpy(np.ascontiguousarray(cam.reshape(height, width), np.float32))
        cam = _resize(cam, size_upsample).numpy()
        cam = np.maximum(cam, 0)
        cam = cam - np.min(cam)
        if np.max(cam) > 0:
            cam = cam / np.max(cam)
        output_cam.append(cam)
    return output_cam
