"""The plain fp32 executor that every architecture's reference runs on.

A reference model (``reference/<name>.py``) is one function,
``forward(ex, x, cfg)``, that names its layers and their widths through the
methods of an ``Executor``: ``conv``, ``dw``, ``pw``, ``bn``, ``dense``,
``se`` and the activations. The executor holds the parameters and running
statistics by ``<layer>/<parameter>`` name, in the layouts of the model's
published checkpoints (conv (O, I, k, k), depthwise (C, k, k), pointwise
(O, C), dense (in, out); batch norm keeps gamma, beta, the running mean and
the running **std**, sqrt(var + eps)), and runs each layer with plain
``torch`` operations on NCHW tensors. It imports nothing of the program.

Modes:

- ``"spec"``: x is one zero image on the CPU and every parameter zeros;
  each layer records its parameters (name, shape, fan-in, kind) and its
  shapes at ``batch`` images. That gives the weights to make and the layer
  table the work counts (``work/counts.py``) read. (Tracing on the ``meta``
  device would import ``torch._dynamo``, two seconds of every set-up.)
- ``"train"``: batch norm normalises by the batch statistics (biased
  variance) and folds them into the running stats at ``momentum``.
- ``"eval"``: batch norm normalises by the running stats.
- ``"calibrate"``: each batch norm first sets its running stats from the
  input it sees (the channel mean plus 0.1 std of noise, the channel's
  sqrt(var + eps) times U(0.5, 1.5), drawn from ``generator``), then normalises by them, so
  served activations stay of order one.

Each regularised weight adds 0.5 * strength * sum(w^2) to the objective.
``reported`` marks whether the term is in the reported loss: the
reference's accounting leaves out the residual blocks' skip projections.
"""

import math

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.95
L2 = 1e-4


def make_divisible(v, divisor=8):
    """The MobileNet channel rounding (the TF models' ``_make_divisible``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Executor:
    def __init__(self, mode, params=None, stats=None, generator=None, batch=None):
        if mode not in ("spec", "train", "eval", "calibrate"):
            raise ValueError("unknown mode {!r}".format(mode))
        self.mode = mode
        self.params = {} if params is None else params
        self.stats = {} if stats is None else stats
        self.generator = generator
        self.batch = batch          # the batch the spec mode's shapes are given at
        self.spec = []      # (name, shape, fan_in, kind), in call order
        self.layers = []    # one dict a layer: its op, name and shapes
        self.reg = []       # (weight name, reported) of every l2 term

    # ---- bookkeeping ---------------------------------------------------
    def _param(self, name, shape, fan_in, kind):
        if self.mode == "spec":
            self.spec.append((name, tuple(shape), fan_in, kind))
            return torch.zeros(shape)
        p = self.params[name]
        if tuple(p.shape) != tuple(shape):
            raise ValueError("{}: expected shape {}, got {}".format(name, tuple(shape),
                                                                     tuple(p.shape)))
        return p

    def _record(self, op, name, x, y, **kw):
        if self.mode == "spec":
            self.layers.append(dict(op=op, name=name, x=(self.batch,) + tuple(x.shape[1:]),
                                    y=(self.batch,) + tuple(y.shape[1:]), **kw))
        return y

    def _weight(self, name, shape, fan_in, reg, reported=True, kind="weight"):
        w = self._param(name + "/weights", shape, fan_in, kind)
        if reg:
            self.reg.append((name + "/weights", reported))
        return w

    def _bias(self, name, n):
        return self._param(name + "/bias", (n,), None, "bias")

    def reg_terms(self):
        """(reported, full): the l2 terms of the reported loss and of the
        objective the gradient is taken of."""
        full = reported = 0.0
        for name, rep in self.reg:
            term = 0.5 * L2 * torch.sum(torch.square(self.params[name]))
            full = full + term
            if rep:
                reported = reported + term
        return reported, full

    # ---- layers --------------------------------------------------------
    def conv(self, name, x, out_ch, k, stride, pad, reg=True):
        w = self._weight(name, (out_ch, x.shape[1], k, k), x.shape[1] * k * k, reg)
        y = F.conv2d(x, w, stride=stride, padding=pad)
        return self._record("conv", name, x, y, k=k, stride=stride)

    def dw(self, name, x, k, stride, pad):
        C = x.shape[1]
        w = self._weight(name, (C, k, k), k * k, reg=False)
        y = F.conv2d(x, w.unsqueeze(1), stride=stride, padding=pad, groups=C)
        return self._record("dw", name, x, y, k=k, stride=stride)

    def pw(self, name, x, out_ch, stride=1, reg=True, reported=True):
        """1x1 conv; stride > 1 subsamples the grid first (output ceil(H/s))."""
        w = self._weight(name, (out_ch, x.shape[1]), x.shape[1], reg, reported)
        xs = x[:, :, ::stride, ::stride] if stride > 1 else x
        y = torch.einsum("nchw,oc->nohw", xs, w)
        return self._record("pw", name, x, y, stride=stride)

    def dense(self, name, x, out, reg=True):
        w = self._weight(name, (x.shape[1], out), x.shape[1], reg, kind="dense")
        b = self._bias(name, out)
        y = x @ w + b
        return self._record("dense", name, x, y)

    def bn(self, name, x):
        C = x.shape[1]
        gamma = self._param(name + "/gamma", (C,), None, "gamma")
        beta = self._param(name + "/beta", (C,), None, "beta")
        self._record("bn", name, x, x)
        if self.mode == "spec":
            return x
        view = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        if self.mode == "calibrate":
            with torch.no_grad():
                std = torch.sqrt(x.var(dim=dims, unbiased=False) + EPS)
                noise = torch.randn(C, generator=self.generator, device=x.device)
                scale = torch.rand(C, generator=self.generator, device=x.device) + 0.5
                self.stats[name] = (x.mean(dim=dims) + 0.1 * std * noise, std * scale)
        if self.mode == "train":
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            inv = torch.rsqrt(var + EPS)
            with torch.no_grad():
                rm, rs = self.stats[name]
                self.stats[name] = (MOMENTUM * rm + (1 - MOMENTUM) * mean,
                                    MOMENTUM * rs + (1 - MOMENTUM) * torch.sqrt(var + EPS))
            x_hat = (x - mean.view(view)) * inv.view(view)
        else:
            rm, rs = self.stats[name]
            x_hat = (x - rm.view(view)) / rs.view(view)
        return gamma.view(view) * x_hat + beta.view(view)

    def se(self, name, x, reduced):
        """Squeeze-excite: the spatial mean, a ReLU FC to ``reduced``, a
        hard-sigmoid FC back to C, the channel gate."""
        C = x.shape[1]
        w_r = self._param(name + "/w_reduce", (C, reduced), C, "weight")
        b_r = self._param(name + "/b_reduce", (reduced,), None, "bias")
        w_e = self._param(name + "/w_expand", (reduced, C), reduced, "weight")
        b_e = self._param(name + "/b_expand", (C,), None, "bias")
        self.reg += [(name + "/w_reduce", True), (name + "/w_expand", True)]
        self._record("se", name, x, x, reduced=reduced)
        if self.mode == "spec":
            return x
        s = x.mean(dim=(2, 3))
        g = hard_sigmoid(torch.relu(s @ w_r + b_r) @ w_e + b_e)
        return x * g[:, :, None, None]

    def gap(self, x):
        return x.mean(dim=(2, 3))


def relu(x):
    return torch.relu(x)


def hard_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


def layer_table(forward, cfg, batch):
    """(param spec, layer table, reg terms) of ``forward`` at ``batch``
    images of the configuration's input size."""
    ex = Executor("spec", batch=batch)
    H, W = cfg["image_hw"]
    with torch.no_grad():
        forward(ex, torch.zeros((1, 3, H, W)), cfg)
    return ex.spec, ex.layers, ex.reg


def fan_in_std(fan_in):
    """He-normal scale."""
    return math.sqrt(2.0 / fan_in)
