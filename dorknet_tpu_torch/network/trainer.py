"""Trainer — the training step (counterpart of
``dorknet_tpu/network/trainer.py``).

``step(X, y_one_hot)`` runs one training forward and backward
(``FeedForwardNetwork._loss_and_grads``: batch-stat BN, the data loss plus
every l2 term differentiated, the reference's loss reported), clips the
gradients to a global L2 norm in fp32 when asked, applies the optimiser's
update to the parameters in place, and folds the new parameters into an
exponential moving average when asked. It returns the loss and the argmax
predictions as tensors on the device, without waiting for them. On a CUDA
device the depthwise layers' forward and backward run the hand-written
kernels (``ops/cuda/depthwise.py``).

The augmented steps take precrop-size uint8 BGR batches: ``step_augmented``
runs ``data_loading/device_augment.py:train_pipeline`` (crop, HSV, rotation
and flip in the hand-written kernel of ``ops/cuda/augment.py`` on the card,
then the -128 shift and mixup) with NHWC output, then the same update as
``step``. ``step_augmented_indexed`` first gathers the rows of a
device-resident dataset and one-hots their labels on the device, so a step
moves only its (B,) row indices from the host. Random draws come from an
explicit ``torch.Generator`` on the trainer's device.

The JAX package compiles each step into one program; here it runs eagerly.
A fresh network's first step adopts the batch statistics into the running
stats of every batch norm, an ordinary Python branch. ``multi_step`` and
the ``multi_step_augmented*`` pair are loops of their single steps.
``accumulate_step`` and ``remat`` are not ported yet.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F

from dorknet_tpu_torch.data_loading.device_augment import train_pipeline
from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.network.inference import resolve_device


def _stacked(steps):
    """(losses (K,), preds (K, ...)) from K (loss, preds) pairs."""
    return (torch.stack([loss for loss, _ in steps]),
            torch.stack([preds for _, preds in steps]))


class Trainer:
    def __init__(self, network, optimiser, input_layout="NCHW", ema_decay=None,
                 clip_norm=None, device="cuda"):
        """input_layout "NHWC" takes batches already in the internal layout.
        ema_decay (e.g. 0.999) keeps an EMA of the parameters, initialised
        to them at the first step; read it with ``ema_params()`` or serve it
        with ``ema_network()``. clip_norm rescales the gradients to at most
        that global L2 norm before the update. device: where the network
        trains, the card by default; the network is moved there in place."""
        if input_layout not in ("NCHW", "NHWC"):
            raise ValueError("input_layout must be 'NCHW' or 'NHWC', got {!r}".format(
                input_layout))
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        if self.clip_norm is not None and self.clip_norm <= 0:
            raise ValueError("clip_norm must be positive")
        self.device = resolve_device(device, "Trainer")
        self.network = network.to(self.device)
        self.optimiser = optimiser
        self.input_layout = input_layout
        self._cache = None        # optimiser state over network.parameters()
        self._cache_owner = None  # the optimiser that made it
        self._ema = None          # shadow parameters, when ema_decay is set

    def _prepare(self):
        """The parameters, with the optimiser's state (made anew when the
        optimiser object changes) and the EMA shadow in place."""
        params = list(self.network.parameters())
        if self._cache_owner is not self.optimiser:
            self._cache = self.optimiser.init_cache(params)
            self._cache_owner = self.optimiser
        if self.ema_decay is not None and self._ema is None:
            self._ema = [p.detach().clone() for p in params]
        return params

    def _place(self, X, y_one_hot):
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y_one_hot, dtype=torch.float32, device=self.device)
        x = X.contiguous() if self.input_layout == "NHWC" else to_nhwc(X)
        return x, y

    def _clip_grads(self, grads):
        """Scale every gradient by min(1, clip_norm / global L2 norm); the
        norm in fp32, on the device."""
        if self.clip_norm is None:
            return grads
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.float() for g in grads])))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def step(self, X, y_one_hot):
        """One training step. X: (B,C,H,W) (or (B,H,W,C) with input_layout
        "NHWC"); y_one_hot: (B, classes), soft labels allowed. Returns (loss,
        predicted class ids) as device tensors."""
        x, y = self._place(X, y_one_hot)
        return self._train(x, y)

    def _train(self, x, y):
        """The step on NHWC float32 x and labels y, both on the device."""
        params = self._prepare()
        loss, probs, grads = self.network._loss_and_grads(x, y, params)
        grads = self._clip_grads(grads)
        with torch.no_grad():
            self._cache = self.optimiser.apply_update(
                params, grads, self._cache, self.optimiser.learning_rate)
            if self._ema is not None:
                d = self.ema_decay
                torch._foreach_mul_(self._ema, d)
                torch._foreach_add_(self._ema, torch._foreach_mul(params, 1.0 - d))
        return loss, probs.argmax(dim=1)

    def multi_step(self, X_stack, y_stack):
        """K steps, one after another. X_stack: (K, B, ...), y_stack: (K, B,
        classes). Returns (losses (K,), preds (K, B))."""
        return _stacked([self.step(X_stack[i], y_stack[i]) for i in range(len(X_stack))])

    def step_augmented(self, generator, X_precrop, one_hot, out_hw, hsv_pert_tuples=None,
                       rotation_tuple=None, horizontal_flip_prob=None, crop_mode="random",
                       mixup=None):
        """One augment-and-train step. X_precrop: (B, H, W, 3) BGR in [0, 255],
        uint8 (on the card it must be: the kernel is uint8-only), a numpy
        array or a tensor; one_hot: (B, classes). generator: a
        ``torch.Generator`` on the trainer's device. With mixup the step
        trains 2B images. Equal to ``train_pipeline(generator, ...,
        output_layout="NHWC")`` followed by ``step`` of an NHWC trainer.
        Returns (loss, preds) as device tensors."""
        X = torch.as_tensor(X_precrop, device=self.device)
        y = torch.as_tensor(one_hot, dtype=torch.float32, device=self.device)
        x, y = train_pipeline(generator, X, y, out_hw, hsv_pert_tuples, rotation_tuple,
                              horizontal_flip_prob, crop_mode, mixup, output_layout="NHWC")
        return self._train(x.float(), y)

    def step_augmented_indexed(self, generator, images, labels, rows, out_hw, num_classes,
                               hsv_pert_tuples=None, rotation_tuple=None,
                               horizontal_flip_prob=None, crop_mode="random", mixup=None):
        """One gather-augment-train step over a device-resident dataset
        (``DeviceResidentDataset``): images (N, H, W, 3) uint8 and labels (N,)
        int on the trainer's device; rows (B,) row indices, the only data a
        step moves from the host. Equal to ``step_augmented(generator,
        images[rows], one_hot(labels[rows]), ...)``. Host rows (a sequence,
        a numpy array or a CPU tensor) are checked against the dataset's
        length before they reach the card; rows already on the card are
        trusted, since checking them would wait on the card every step, and
        an out-of-range one there is a device-side assert."""
        if not isinstance(rows, torch.Tensor) or rows.device.type == "cpu":
            rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64)
            if rows.numel() and (rows.min() < 0 or rows.max() >= len(images)):
                raise IndexError("rows must lie in [0, {}), got {}..{}".format(
                    len(images), int(rows.min()), int(rows.max())))
        rows = torch.as_tensor(rows, dtype=torch.int64).to(self.device, non_blocking=True)
        X = images.index_select(0, rows)
        y = F.one_hot(labels.index_select(0, rows).long(), int(num_classes)).float()
        return self.step_augmented(generator, X, y, out_hw, hsv_pert_tuples, rotation_tuple,
                                   horizontal_flip_prob, crop_mode, mixup)

    def multi_step_augmented(self, generator, X_stack, y_stack, out_hw, **aug):
        """K augmented steps, one after another, drawing from ``generator`` in
        step order. X_stack: (K, B, H, W, 3); y_stack: (K, B, classes).
        Returns (losses (K,), preds (K, B or 2B))."""
        return _stacked([self.step_augmented(generator, X_stack[i], y_stack[i], out_hw, **aug)
                         for i in range(len(X_stack))])

    def multi_step_augmented_indexed(self, generator, images, labels, rows_stack, out_hw,
                                     num_classes, **aug):
        """K indexed augmented steps, one after another. rows_stack: (K, B)."""
        return _stacked([self.step_augmented_indexed(generator, images, labels, rows_stack[i],
                                                     out_hw, num_classes, **aug)
                         for i in range(len(rows_stack))])

    def ema_network(self):
        """A deep copy of the network carrying the EMA parameters, to serve
        or to save."""
        if self._ema is None:
            raise ValueError("no EMA yet: construct Trainer(ema_decay=...) "
                             "and run at least one step")
        net = copy.deepcopy(self.network)
        with torch.no_grad():
            for p, e in zip(net.parameters(), self._ema, strict=True):
                p.copy_(e)
        return net

    def ema_params(self):
        """The EMA parameters in the shape of ``network.gather_params()``
        (numpy leaves), or None before the first step."""
        if self._ema is None:
            return None
        return self.ema_network().gather_params()
