"""Functional ops over NHWC tensors (counterpart of ``dorknet_tpu.ops``)."""

from dorknet_tpu_torch.ops.conv import conv2d, depthwise_conv2d, pointwise_conv2d, dense
from dorknet_tpu_torch.ops.norm import batch_norm_inference
from dorknet_tpu_torch.ops.pool import global_avg_pool
from dorknet_tpu_torch.ops.loss import softmax_probs

__all__ = [
    "conv2d",
    "depthwise_conv2d",
    "pointwise_conv2d",
    "dense",
    "batch_norm_inference",
    "global_avg_pool",
    "softmax_probs",
]
