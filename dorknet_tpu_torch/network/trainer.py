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
explicit ``torch.Generator`` on the trainer's device. ``multi_step`` and the
``multi_step_augmented*`` pair are loops of their single steps;
``accumulate_step`` runs K forward and backward passes and one update.

One program per step. The JAX package compiles each step into one donated
program; here, on the card, each entry point captures its step into a
``torch.cuda.CUDAGraph`` and replays it, one graph launch a step. Every
tensor the step reads or writes keeps its address (parameters, optimiser
state, EMA, batch-norm running stats and the device lr are all updated in
place), and each call copies its inputs into the graph's own buffers, host
arrays through pinned memory. Graphs are keyed like the JAX package's
compiled steps: the inputs' shapes and dtypes, the layout, ``remat``, clip
and EMA, the optimiser (the object and its ``hyper_key()``), the
compute dtype, the network's ``_version`` and its batch norms' state, and
for the augmented steps the augmentation, the generator and the dataset; a
change, or one of the cuDNN and TF32 settings of ``torch.backends``,
captures a new graph into the trainer's one memory pool. A graph is
captured only once every batch norm is set: a fresh network's first step
adopts the batch statistics in a Python branch and runs eagerly, and the
first step of each new key runs eagerly on a side stream before the capture
(the warm-up capture needs). Both are real steps. A capture that fails
raises after its warm-up step was applied, and every later call with its
key raises without taking a step; nothing falls back to the eager step.
``cuda_graph=False`` runs every step eagerly, and the CPU always does. The
kernels' ``.launches`` counters are bumped in Python, so a replay leaves
them as they are.

Spans (``utils/tracing.span``: ``torch.profiler`` ranges named
``dorknet.<span>`` while a profiler records, nothing otherwise):
``trainer.step`` around each step entry (``step``, ``step_augmented``,
``step_augmented_indexed``, ``accumulate_step``; the ``multi_*`` loops open
one a step), ``trainer.rows`` around the host rows' conversion and range
check, ``trainer.key`` around the state, the signature and the graph
lookup, ``trainer.eager`` around an eager step (adoption, warm-up,
``cuda_graph=False``, the CPU), ``trainer.capture`` around a capture, and
in a replay ``trainer.stage`` (the pinned ring and the input copies),
``trainer.replay`` (``graph.replay()``) and ``trainer.outputs`` (the
output clones).

``remat`` (True or "blocks") recomputes the forward's activations in the
backward through ``torch.utils.checkpoint``: True the whole layer stack,
"blocks" each ``ResidualBlock``. The recomputation leaves the batch norms'
running stats alone (``layers/batch_norm.py:running_stats_frozen``), so each
micro-batch folds its statistics in once, as the JAX package's functional
recomputation does.
"""

import contextlib
import copy
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dorknet_tpu_torch.config import get_compute_dtype
from dorknet_tpu_torch.data_loading.device_augment import train_pipeline
from dorknet_tpu_torch.data_loading.prefetch import PinnedRing
from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.layers.batch_norm import running_stats_frozen
from dorknet_tpu_torch.layers.residual_block import ResidualBlock
from dorknet_tpu_torch.network.inference import resolve_device
from dorknet_tpu_torch.utils.tracing import span


def _stacked(steps):
    """(losses (K,), preds (K, ...)) from K (loss, preds) pairs."""
    return (torch.stack([loss for loss, _ in steps]),
            torch.stack([preds for _, preds in steps]))


def _remat(module, fn, *args):
    """fn(*args), the forward of ``module``, with its activations recomputed
    in the backward; the recomputation leaves the module's running stats
    alone. The forward draws no random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen(module)))


def _remat_blocks(layer, apply):
    if isinstance(layer, ResidualBlock):
        return functools.partial(_remat, layer, apply)
    return apply


def _backend_flags():
    """The torch settings a capture bakes in: the cuDNN algorithm choice and
    the TF32 precision of the matmuls and convolutions."""
    backends = torch.backends
    return (backends.cudnn.deterministic, backends.cudnn.benchmark,
            backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)


def _frozen(v):
    """Lists to tuples, all the way down (configs arrive as lists)."""
    return tuple(_frozen(e) for e in v) if isinstance(v, (list, tuple)) else v


class _FailedCapture:
    """A key whose capture failed, and why (the error itself is not kept:
    its traceback holds the capture's buffers)."""

    def __init__(self, err):
        self.why = "{}: {}".format(type(err).__name__, err)


class _StepGraph:
    """One captured step: the graph, the buffers it reads its inputs from
    and the tensors it writes its outputs to. ``keep`` holds what the graph
    reads by address, keyed only by its identity (a resident dataset)."""

    def __init__(self, graph, inputs, outputs, keep):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.keep = keep
        self._ring = None  # pinned staging of host inputs, made at first need

    def replay(self, args):
        """Copy ``args`` into the input buffers, replay, and return copies
        of the outputs (the next replay overwrites the buffers)."""
        with span("trainer.stage"):
            host = any(a.device.type == "cpu" for a in args)
            if host:
                if self._ring is None:
                    self._ring = PinnedRing(2)
                slot = self._ring.acquire()
            for i, (buf, a) in enumerate(zip(self.inputs, args, strict=True)):
                if a.device.type == "cpu":
                    a = self._ring.view(slot, i, a.dtype, a.shape).copy_(a)
                buf.copy_(a, non_blocking=True)
            if host:
                self._ring.release(slot, self.inputs[0].device)
        with span("trainer.replay"):
            self.graph.replay()
        with span("trainer.outputs"):
            return tuple(o.clone() for o in self.outputs)


class Trainer:
    def __init__(self, network, optimiser, input_layout="NCHW", ema_decay=None,
                 clip_norm=None, device="cuda", remat=False, cuda_graph=True):
        """input_layout "NHWC" takes batches already in the internal layout.
        ema_decay (e.g. 0.999) keeps an EMA of the parameters, initialised
        to them at the first step; read it with ``ema_params()`` or serve it
        with ``ema_network()``. clip_norm rescales the gradients to at most
        that global L2 norm before the update. device: where the network
        trains, the card by default; the network is moved there in place.
        remat: False, True (recompute the whole forward in the backward) or
        "blocks" (each ResidualBlock). cuda_graph: on the card, capture each
        step into a CUDA graph and replay it (the default); False runs the
        steps eagerly. The CPU always runs them eagerly."""
        if input_layout not in ("NCHW", "NHWC"):
            raise ValueError("input_layout must be 'NCHW' or 'NHWC', got {!r}".format(
                input_layout))
        if remat not in (False, True, "blocks"):
            raise ValueError("remat must be False, True or 'blocks', got {!r}".format(remat))
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.clip_norm = None if clip_norm is None else float(clip_norm)
        if self.clip_norm is not None and self.clip_norm <= 0:
            raise ValueError("clip_norm must be positive")
        self.device = resolve_device(device, "Trainer")
        self.network = network.to(self.device)
        self.optimiser = optimiser
        self.input_layout = input_layout
        self.remat = remat
        self.cuda_graph = bool(cuda_graph) and self.device.type == "cuda"
        self._cache = None        # optimiser state over network.parameters()
        self._cache_owner = None  # the optimiser that made it
        self._ema = None          # shadow parameters, when ema_decay is set
        self._graphs = {}         # the captured steps, by key
        self._pool = None         # the memory pool they share
        self._stream = None       # the side stream of warm-ups and captures
        self.captures = 0         # graphs captured so far
        self.capture_seconds = 0.0  # host seconds of the last capture

    # ------------------------------------------------------------------ #
    # State
    # ------------------------------------------------------------------ #
    def _prepare(self):
        """The parameters, with the optimiser's state (made anew when the
        optimiser object changes, which drops every captured graph: they
        read the old state), the EMA shadow and the device lr in place."""
        params = list(self.network.parameters())
        if self._cache_owner is not self.optimiser:
            self._cache = self.optimiser.init_cache(params)
            self._cache_owner = self.optimiser
            self._graphs.clear()
        if self.ema_decay is not None and self._ema is None:
            self._ema = [p.detach().clone() for p in params]
        self.optimiser.device_lr()
        return params

    def _signature(self):
        """What a captured step bakes in besides its inputs (the JAX
        trainer's ``_signature``, with the optimiser object in place of its
        class: the graph reads that object's state)."""
        opt = self.optimiser
        return (self.network._version, self.remat, self.input_layout, self.ema_decay,
                self.clip_norm, opt, opt.hyper_key(), get_compute_dtype(),
                tuple(l.bn_initialized() for l in self.network.layers), _backend_flags())

    # ------------------------------------------------------------------ #
    # Capture and replay
    # ------------------------------------------------------------------ #
    def _run(self, key, body, args, generator=None, keep=()):
        """body(*args) -> tuple of tensors: eagerly, or through the graph
        captured for ``key`` (captured now if there is none). args are
        tensors, on the host or on the device. A capture that fails raises
        after its warm-up, a real step, was applied; later calls with that
        key raise at once and take no step."""
        with span("trainer.key"):
            self._prepare()
            eager = not self.cuda_graph or not all(l.bn_initialized()
                                                   for l in self.network.layers)
            if not eager:
                key = key + self._signature() + tuple((tuple(a.shape), a.dtype) for a in args)
                graph = self._graphs.get(key)
        if eager:
            with span("trainer.eager"):
                return body(*args)
        if isinstance(graph, _FailedCapture):
            raise RuntimeError("this step's capture failed on an earlier call, whose warm-up "
                               "step was applied; no step was taken ({})".format(graph.why))
        if graph is not None:
            return graph.replay(args)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream), span("trainer.eager"):
            out = body(*args)  # the warm-up: a real step
        main.wait_stream(self._stream)
        try:
            self._graphs[key] = self._capture(body, args, generator, keep)
        except Exception as err:
            self._graphs[key] = _FailedCapture(err)  # later calls raise without a step
            raise RuntimeError("capturing the step failed after its warm-up step was applied "
                               "(parameters, optimiser state, EMA and running stats took "
                               "it)") from err
        return out

    def _capture(self, body, args, generator, keep):
        inputs = [torch.empty_like(a, device=self.device) for a in args]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        t0 = time.perf_counter()
        with span("trainer.capture"), torch.cuda.graph(graph, pool=self._pool,
                                                       stream=self._stream):
            outputs = body(*inputs)
        self.capture_seconds = time.perf_counter() - t0
        self.captures += 1
        return _StepGraph(graph, inputs, outputs, keep)

    # ------------------------------------------------------------------ #
    # The step
    # ------------------------------------------------------------------ #
    def _place(self, X, y_one_hot):
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y_one_hot, dtype=torch.float32, device=self.device)
        x = X.contiguous() if self.input_layout == "NHWC" else to_nhwc(X)
        return x, y

    def _forward(self, x):
        """The train-mode layer stack over NHWC x, rematerialised as
        ``remat`` asks. Returns (out, reported_reg, full_reg)."""
        network = self.network
        if self.remat is True:
            return _remat(network, network._run_layers, x, True)
        return network._run_layers(x, train=True,
                                   layer_wrap=_remat_blocks if self.remat else None)

    def _loss_and_grads(self, x, y, params):
        return self.network._loss_and_grads(x, y, params, self._forward)

    def _clip_grads(self, grads):
        """Scale every gradient by min(1, clip_norm / global L2 norm); the
        norm in fp32, on the device."""
        if self.clip_norm is None:
            return grads
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.float() for g in grads])))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def _train(self, x, y):
        """The step on NHWC float32 x and labels y, both on the device."""
        params = self._prepare()
        loss, probs, grads = self._loss_and_grads(x, y, params)
        self._update(params, grads)
        return loss, probs.argmax(dim=1)

    def _update(self, params, grads):
        """Clip the gradients, apply the optimiser's update to the parameters
        and its state in place, and advance the EMA."""
        grads = self._clip_grads(grads)
        with torch.no_grad():
            self.optimiser.apply_update(params, grads, self._cache,
                                        self.optimiser.device_lr())
            if self._ema is not None:
                d = self.ema_decay
                torch._foreach_mul_(self._ema, d)
                torch._foreach_add_(self._ema, torch._foreach_mul(params, 1.0 - d))

    def step(self, X, y_one_hot):
        """One training step. X: (B,C,H,W) (or (B,H,W,C) with input_layout
        "NHWC"); y_one_hot: (B, classes), soft labels allowed. Returns (loss,
        predicted class ids) as device tensors."""
        with span("trainer.step"):
            X = torch.as_tensor(X, dtype=torch.float32)
            y = torch.as_tensor(y_one_hot, dtype=torch.float32)
            return self._run(("step",), lambda X, y: self._train(*self._place(X, y)), (X, y))

    def accumulate_step(self, X_stack, y_stack):
        """One optimiser update from the mean gradient of K micro-batches.
        X_stack: (K, B, C, H, W) (or (K, B, H, W, C) with input_layout
        "NHWC"); y_stack: (K, B, classes). Each micro-batch's batch norms
        normalise by its own statistics and fold them into the running
        stats, carried from one micro-batch to the next. The K gradients are
        summed, divided by K, clipped, and applied once; the EMA advances
        once. Returns the mean reported loss as a device tensor.

        On a network whose batch norms are unset, a train-mode pass over
        micro-batch 0 first sets their running stats, as the JAX package's
        pre-pass does (it discards that pass's gradients, so here only the
        forward runs). The K micro-batches then fold into those stats,
        micro-batch 0 again: the JAX package's documented double weighting
        of micro-batch 0 on a fresh network (its gradient counts once)."""
        with span("trainer.step"):
            X_stack = torch.as_tensor(X_stack, dtype=torch.float32)
            y_stack = torch.as_tensor(y_stack, dtype=torch.float32)
            if len(X_stack) < 1:
                raise ValueError("accumulate_step needs at least one micro-batch")
            network = self.network
            if not all(l.bn_initialized() for l in network.layers):
                network._train_forward(self._place(X_stack[0], y_stack[0])[0])
                network._pending_grads = None
            (loss,) = self._run(("accumulate",), self._accumulate, (X_stack, y_stack))
            return loss

    def _accumulate(self, X_stack, y_stack):
        K = len(X_stack)
        params = self._prepare()
        g_sum, loss_sum = None, 0.0
        for i in range(K):
            loss, _, grads = self._loss_and_grads(*self._place(X_stack[i], y_stack[i]), params)
            g_sum = grads if g_sum is None else torch._foreach_add(g_sum, grads)
            loss_sum = loss_sum + loss
        self._update(params, torch._foreach_div(g_sum, K))
        return (loss_sum / K,)

    def multi_step(self, X_stack, y_stack):
        """K steps, one after another. X_stack: (K, B, ...), y_stack: (K, B,
        classes). Returns (losses (K,), preds (K, B))."""
        return _stacked([self.step(X_stack[i], y_stack[i]) for i in range(len(X_stack))])

    # ------------------------------------------------------------------ #
    # Augmented steps
    # ------------------------------------------------------------------ #
    def _augmented(self, generator, X, y, out_hw, aug):
        """Augment uint8 X (B,H,W,3) on the device, then train on it."""
        x, y = train_pipeline(generator, X, y, out_hw, *aug, output_layout="NHWC")
        return self._train(x.float(), y)

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
        aug = (_frozen(hsv_pert_tuples), _frozen(rotation_tuple), horizontal_flip_prob,
               crop_mode, _frozen(mixup))
        out_hw = tuple(out_hw)

        def body(X, y):
            return self._augmented(generator, X.to(self.device), y.to(self.device), out_hw,
                                   aug)

        with span("trainer.step"):
            X = torch.as_tensor(X_precrop)
            y = torch.as_tensor(one_hot, dtype=torch.float32)
            return self._run(("aug", out_hw, aug, generator), body, (X, y), generator)

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
        with span("trainer.step"):
            if not isinstance(rows, torch.Tensor) or rows.device.type == "cpu":
                with span("trainer.rows"):
                    rows = torch.as_tensor(np.asarray(rows), dtype=torch.int64)
                    if rows.numel() and (rows.min() < 0 or rows.max() >= len(images)):
                        raise IndexError("rows must lie in [0, {}), got {}..{}".format(
                            len(images), int(rows.min()), int(rows.max())))
            rows = torch.as_tensor(rows, dtype=torch.int64)
            aug = (_frozen(hsv_pert_tuples), _frozen(rotation_tuple), horizontal_flip_prob,
                   crop_mode, _frozen(mixup))
            out_hw, num_classes = tuple(out_hw), int(num_classes)

            def body(rows):
                rows = rows.to(self.device, non_blocking=True)
                X = images.index_select(0, rows)
                y = F.one_hot(labels.index_select(0, rows).long(), num_classes).float()
                return self._augmented(generator, X, y, out_hw, aug)

            # the graph reads the dataset where it lies: its identity is in the
            # key, and the graph keeps it alive
            key = ("aug-idx", out_hw, aug, num_classes, generator, id(images), id(labels),
                   tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype)
            return self._run(key, body, (rows,), generator, keep=(images, labels))

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

    # ------------------------------------------------------------------ #
    # EMA
    # ------------------------------------------------------------------ #
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
