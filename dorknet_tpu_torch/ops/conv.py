"""Convolution / dense ops over NHWC activations.

The counterpart of ``dorknet_tpu/ops/conv.py``, with the same layouts: x is
(N,H,W,C) contiguous; weights keep the reference's layouts (conv (O,I,fh,fw),
depthwise (C,fh,fw), pointwise (O,C), dense (in,out)). The same dtype rules
hold: inputs are cast to the compute dtype, outputs flow in it, and a bias is
added in fp32.

- ``conv2d`` is ``F.conv2d``; the JAX package leaves it to XLA's conv.
- ``depthwise_conv2d`` sends every 3x3 / padding 1 / stride 1-or-2 case to
  the hand-written kernels (``ops/cuda/depthwise.py``: the forward, and in
  training the autograd Function whose backward runs the dx and dw
  kernels), like the JAX package's Pallas dispatch. Any other shape takes
  ``F.conv2d(groups=C)``, the JAX package's own XLA path for shapes its
  kernel does not take. The choice is made by shape alone.
- ``pointwise_conv2d`` and ``dense`` are ``torch.matmul``; stride > 1
  subsamples first (output spatial size ceil(H/s)), as the reference does.

Everything but the depthwise kernels is differentiated by autograd, as the
JAX package leaves those ops to XLA's autodiff.
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.config import get_compute_dtype
from dorknet_tpu_torch.ops.cuda.depthwise import depthwise3x3


def _cast_in(x):
    dt = get_compute_dtype()
    return x.to(dt) if x.dtype != dt else x


_cast_out = _cast_in  # activations flow in the compute dtype


def _bias_add(y, b, bshape):
    """Bias add in fp32, result in y's dtype."""
    if y.dtype == torch.float32:
        return y + b.reshape(bshape)
    return (y.float() + b.reshape(bshape)).to(y.dtype)


def _nhwc_conv(x, w_oihw, stride, padding, groups=1):
    """F.conv2d on an NHWC tensor: the NCHW view is channels-last in memory,
    and the result comes back NHWC-contiguous."""
    y = F.conv2d(_cast_in(x).permute(0, 3, 1, 2), _cast_in(w_oihw),
                 stride=stride, padding=padding, groups=groups)
    return _cast_out(y.permute(0, 2, 3, 1).contiguous())


def conv2d(x, w_oihw, b=None, stride=1, padding=0):
    """Standard conv. x: (N,H,W,C); w_oihw: (O,I,fh,fw). Returns (N,P,Q,O)."""
    y = _nhwc_conv(x, w_oihw, stride, padding)
    if b is not None:
        y = _bias_add(y, b, (1, 1, 1, -1))
    return y


def depthwise_conv2d(x, w_cfhfw, b=None, stride=1, padding=1):
    """Depthwise conv. x: (N,H,W,C); w: (C,fh,fw). Returns (N,P,Q,C)."""
    if stride in (1, 2) and padding == 1 and tuple(w_cfhfw.shape[1:]) == (3, 3):
        y = depthwise3x3(_cast_in(x), w_cfhfw.float(), stride)
    else:
        y = _nhwc_conv(x, w_cfhfw.unsqueeze(1), stride, padding,
                       groups=w_cfhfw.shape[0])
    if b is not None:
        y = _bias_add(y, b, (1, 1, 1, -1))
    return y


def pointwise_conv2d(x, w_oc, b=None, stride=1):
    """1x1 conv as one GEMM over (N*H*W, C) @ (C, O), subsampling first."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    y = _cast_out(torch.matmul(_cast_in(x), _cast_in(w_oc).t()))
    if b is not None:
        y = _bias_add(y, b, (1, 1, 1, -1))
    return y


def dense(x, w_io, b=None):
    """Dense: (N,in) @ (in,out) + b."""
    y = _cast_out(torch.matmul(_cast_in(x), _cast_in(w_io)))
    if b is not None:
        y = _bias_add(y, b, (1, -1))
    return y
