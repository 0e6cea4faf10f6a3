"""Operations and bytes from layer shapes.

The model counts take the layer table of a reference traced on the meta
device (``reference/plain.layer_table``): forward FLOPs are 2 x the
multiply-adds of every convolution, depthwise, pointwise and dense layer and
of the squeeze-excite FCs; batch norm, activations and pooling count 0. A
training step is counted as the forward, the gradient of the weights and
the gradient of the inputs, each as many FLOPs as the forward, less the
first layer's input gradient, which no step computes (the images need no
gradient); no recomputation.

The kernel counts give the least time of one call on the card: the larger
of its bytes over the memory rate (each input byte read once, each output
byte written once) and its operations over the fp32 rate. They follow the
arithmetic of the port's on-chip smoke test (``chip_smoke.py``: ``dw_bytes``,
``dw_bound_ms``, ``augment_bound_ms`` and the batch-norm statistics' bytes).
"""

from benchmark_torch.work.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

# fp32 operations of the augmentation's arithmetic: a pixel's HSV round
# trip, one lerp of a shear, and one line's shift
AUG_HSV_OPS, AUG_LERP_OPS, AUG_SHIFT_OPS = 39, 7, 6


def layer_flops(layer):
    """Forward FLOPs of one entry of a layer table (whole batch)."""
    op = layer["op"]
    if op in ("conv", "dw", "pw"):
        n, o, p, q = layer["y"]
        c_in = layer["x"][1]
        if op == "conv":
            return 2 * n * o * p * q * c_in * layer["k"] ** 2
        if op == "dw":
            return 2 * n * o * p * q * layer["k"] ** 2
        return 2 * n * o * p * q * c_in
    if op == "dense":
        return 2 * layer["x"][0] * layer["x"][1] * layer["y"][1]
    if op == "se":
        n, c = layer["x"][:2]
        return 2 * n * 2 * c * layer["reduced"]
    return 0


def forward_flops_per_image(layers):
    n = layers[0]["x"][0]
    return sum(layer_flops(l) for l in layers) / n


def train_flops_per_image(layers):
    """3 x the forward, less the first layer's input gradient."""
    first = next(l for l in layers if layer_flops(l))
    return 3 * forward_flops_per_image(layers) - layer_flops(first) / layers[0]["x"][0]


def _bound_ms(n_bytes, ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3


def dw3x3_layers(layers):
    """(N, H, W, C, stride) of every 3x3 depthwise layer's input."""
    return [(l["x"][0], l["x"][2], l["x"][3], l["x"][1], l["stride"])
            for l in layers if l["op"] == "dw" and l["k"] == 3]


def _dw_out(H, W, stride, k):
    """The output grid of a k x k depthwise pass with padding k // 2."""
    p = k // 2
    return (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1


def dw_bytes(N, H, W, C, stride, k=3):
    """fp32 bytes of one depthwise k x k pass (forward, dx or dw; padding
    k // 2): the input activation and the output activation each read or
    written once (for odd k the output is ceil(H / stride) on a side)."""
    Ho, Wo = _dw_out(H, W, stride, k)
    return (N * H * W * C + N * Ho * Wo * C) * 4


def dw_bound_ms(N, H, W, C, stride, k=3):
    """The least time of one depthwise k x k pass: its bytes, or its 2 k^2
    flops an output element."""
    Ho, Wo = _dw_out(H, W, stride, k)
    return _bound_ms(dw_bytes(N, H, W, C, stride, k), 2.0 * k * k * N * Ho * Wo * C)


def bn_layers(layers):
    """(N, H, W, C) of every 4-D batch norm's input."""
    return [(l["x"][0], l["x"][2], l["x"][3], l["x"][1]) for l in layers
            if l["op"] == "bn" and len(l["x"]) == 4]


def bn_stats_bound_ms(N, H, W, C):
    """One fp32 read of x, and a sum, a multiply and an add an element."""
    n = N * H * W * C
    return _bound_ms(4 * n, 3.0 * n)


def augment_bound_ms(B, oh, ow, P):
    """The least time of one cropping augmentation call: the oh x ow window
    read and the output written once, uint8, three channels; HSV once a
    pixel, the shear lerps of every channel, the line shifts once an
    image."""
    n_bytes = B * 3 * (oh * ow + oh * ow)
    ops = AUG_HSV_OPS * B * oh * ow
    if P:
        Wp = ow + 2 * P
        ops += AUG_LERP_OPS * B * 3 * (2 * oh * Wp + oh * ow) + AUG_SHIFT_OPS * B * (oh + Wp)
    return _bound_ms(n_bytes, ops)
