"""Functional ops over NHWC tensors (counterpart of ``dorknet_tpu.ops``)."""

from dorknet_tpu_torch.ops.conv import conv2d, depthwise_conv2d, pointwise_conv2d, dense
from dorknet_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train, layer_norm
from dorknet_tpu_torch.ops.pool import global_avg_pool
from dorknet_tpu_torch.ops.loss import softmax_cross_entropy, softmax_probs

__all__ = [
    "conv2d",
    "depthwise_conv2d",
    "pointwise_conv2d",
    "dense",
    "batch_norm_inference",
    "batch_norm_train",
    "layer_norm",
    "global_avg_pool",
    "softmax_cross_entropy",
    "softmax_probs",
]
