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
  kernels), like the JAX package's Pallas dispatch. A 7x7 / padding 3 /
  stride 1 case with C a multiple of 4 (ConvNeXt's) that needs a gradient
  goes through ``ops/cuda/depthwise7x7.Depthwise7x7Fn``: cuDNN's forward and
  dx, as below, and the hand-written weight gradient. Any other shape, and
  that one without a gradient, takes ``F.conv2d(groups=C)``, the JAX
  package's own XLA path for shapes its kernel does not take. The choice is
  made by shape alone.
- ``pointwise_conv2d`` and ``dense`` are ``torch.matmul``; stride > 1
  subsamples first (output spatial size ceil(H/s)), as the reference does.

Each takes ``act``, the activation that follows the layer (``"none"``,
``"relu"`` or ``"hswish"``; ``layers/sequence.run_layers`` hands it over in
test mode), with a bias. Where no gradient is needed, the bias add and the
activation are one hand-written pass, ``bias_act`` (``ops/cuda/bias_act.py``),
bit-equal to the add then the activation layer; where one is needed they are
``bias_add`` then the activation's ops under autograd. With ``act=None``
(the default) only the bias is added, by ``bias_add``.

Everything but the depthwise kernels (and the 7x7 weight gradient) is
differentiated by autograd, as the JAX package leaves those ops to XLA's
autodiff (``bias_act`` runs only where no gradient is needed).
"""

import torch
import torch.nn.functional as F

from dorknet_tpu_torch.config import get_compute_dtype
from dorknet_tpu_torch.ops.activation import BN_ACTIVATIONS
from dorknet_tpu_torch.ops.cuda.bias_act import bias_act, bias_add
from dorknet_tpu_torch.ops.cuda.depthwise import depthwise3x3
from dorknet_tpu_torch.ops.cuda.depthwise7x7 import Depthwise7x7Fn


def _cast_in(x):
    dt = get_compute_dtype()
    return x.to(dt) if x.dtype != dt else x


_cast_out = _cast_in  # activations flow in the compute dtype


def _bias_act(y, b, act):
    """y + b (fp32 add, y's dtype), then ``act`` when one is given: one
    ``bias_act`` pass where no gradient is needed, else the eager chain."""
    if act is None:
        return y if b is None else bias_add(y, b)
    if torch.is_grad_enabled() and (y.requires_grad or b.requires_grad):
        return BN_ACTIVATIONS[act](bias_add(y, b))
    return bias_act(y, b, act)


def _nhwc_conv(x, w_oihw, stride, padding, groups=1):
    """F.conv2d on an NHWC tensor: the NCHW view is channels-last in memory,
    and the result comes back NHWC-contiguous."""
    y = F.conv2d(_cast_in(x).permute(0, 3, 1, 2), _cast_in(w_oihw),
                 stride=stride, padding=padding, groups=groups)
    return _cast_out(y.permute(0, 2, 3, 1).contiguous())


def conv2d(x, w_oihw, b=None, stride=1, padding=0, act=None):
    """Standard conv. x: (N,H,W,C); w_oihw: (O,I,fh,fw). Returns (N,P,Q,O)."""
    return _bias_act(_nhwc_conv(x, w_oihw, stride, padding), b, act)


def depthwise_conv2d(x, w_cfhfw, b=None, stride=1, padding=1, act=None):
    """Depthwise conv. x: (N,H,W,C); w: (C,fh,fw). Returns (N,P,Q,C)."""
    if stride in (1, 2) and padding == 1 and tuple(w_cfhfw.shape[1:]) == (3, 3):
        y = depthwise3x3(_cast_in(x), w_cfhfw.float(), stride)
    elif (stride == 1 and padding == 3 and tuple(w_cfhfw.shape[1:]) == (7, 7)
          and w_cfhfw.shape[0] % 4 == 0 and torch.is_grad_enabled()
          and (x.requires_grad or w_cfhfw.requires_grad)):
        y = Depthwise7x7Fn.apply(_cast_in(x), w_cfhfw)
    else:
        y = _nhwc_conv(x, w_cfhfw.unsqueeze(1), stride, padding,
                       groups=w_cfhfw.shape[0])
    return _bias_act(y, b, act)


def pointwise_conv2d(x, w_oc, b=None, stride=1, act=None):
    """1x1 conv as one GEMM over (N*H*W, C) @ (C, O), subsampling first."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    return _bias_act(_cast_out(torch.matmul(_cast_in(x), _cast_in(w_oc).t())), b, act)


def dense(x, w_io, b=None, act=None):
    """Dense: (N,in) @ (in,out) + b."""
    return _bias_act(_cast_out(torch.matmul(_cast_in(x), _cast_in(w_io))), b, act)
