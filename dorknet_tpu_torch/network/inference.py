"""Batched inference runner — the serving path (counterpart of
``dorknet_tpu/network/inference.py``).

Every dispatch runs one fixed batch shape: ragged tails are padded with
zeros and sliced off, so each kernel sees the same shapes on every call. The
runner serves a snapshot, as the JAX runner means to (it gathers parameters
and states at construction and again in ``refresh()``): its own copy of the
caller's network on the runner's device (the card unless the caller asks
for the CPU), which training the caller's network does not change until
``refresh()``. The caller's network stays where it was and as it was.
``fold_bn=True`` folds every conv→BN pair of that copy (``utils/fold_bn``),
and ``refresh()`` then re-folds from the caller's network in place.

``predict_probs`` copies each batch to the device, runs it under
``torch.inference_mode()`` and brings the probabilities back as numpy.
``predict_iter`` streams batches through ``device_prefetch``'s pinned ring
and brings each batch's probabilities back through pinned buffers while the
next batch runs. ``export_program`` writes the test-mode forward as a
``torch.export`` program, which ``serving_artifact.load_serving_artifact``
reloads without the model code.

Spans (``utils/tracing.span``, while ``torch.profiler`` records),
in ``predict_iter``: ``runner.forward`` around queuing one batch's forward,
``runner.fetch`` around queuing its probabilities' copy back, and
``runner.answer`` around waiting for and unpacking the previous batch's
probabilities; ``device_prefetch`` adds ``prefetch.stage`` and the pinned
rings ``ring.wait``. ``predict_probs`` opens none.
"""

import copy
import io
import json

import numpy as np
import torch

from dorknet_tpu_torch.layers.base import Layer
from dorknet_tpu_torch.serving_artifact import (  # noqa: F401 (exported here too)
    ServingArtifact, describe, load_serving_artifact, load_serving_program)
from dorknet_tpu_torch.utils.fold_bn import fold_in_place, refold
from dorknet_tpu_torch.utils.tracing import span

# predict_iter's pinned rings: device_prefetch's (two batches ahead, one more
# slot) and the probabilities' (the batch being read back and the next)
_PREFETCH = 2
_PROBS_SLOTS = 2


def resolve_device(device, who):
    """torch.device(device); a CUDA device without a usable card raises, so
    an entry point never carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "{} runs on {} by default, but no CUDA device is available; pass "
            "device='cpu' to run on the CPU".format(who, device))
    return device


def _snapshot(network, device):
    """A copy of ``network`` on ``device``, without the gradients its last
    training forward left (they are not served). ``network`` is unchanged."""
    memo = {id(l.grads): {} for l in network.modules() if isinstance(l, Layer)}
    if network._pending_grads is not None:
        memo[id(network._pending_grads)] = None
    return copy.deepcopy(network, memo).to(device)


class _TestForward(torch.nn.Module):
    """The network's test-mode forward as a module, for ``torch.export``."""

    def __init__(self, network):
        super().__init__()
        self.network = network

    def forward(self, x):
        return self.network._test_fn(x)


class InferenceRunner:
    def __init__(self, network, batch_size, device="cuda", fold_bn=False):
        """device: where the runner serves, the card by default. It serves
        its own copy of ``network`` there (``self.network``), BN-folded when
        ``fold_bn``; ``network`` itself is kept as the source of
        ``refresh()``."""
        network._require_bn_initialized("InferenceRunner")
        self.device = resolve_device(device, "InferenceRunner")
        self._source = network
        self._fold = bool(fold_bn)
        self.network = _snapshot(network, self.device).requires_grad_(False)
        if self._fold:
            fold_in_place(self.network)
        self.batch_size = int(batch_size)
        self.pinned_rings = None  # (inputs, probs) of the last predict_iter on the card

    def refresh(self):
        """Bring the served copy up to the source network's current
        parameters and batch-norm running statistics, in place (no second
        copy is allocated on the device): the counterpart of the JAX
        runner's re-gathering (and re-folding, for a folded runner) after
        further training of the source."""
        with torch.no_grad():
            if self._fold:
                refold(self.network, self._source)
                return
            for served, source in [(self.network.parameters(), self._source.parameters()),
                                   (self.network.buffers(), self._source.buffers())]:
                for dst, src in zip(served, source, strict=True):
                    dst.copy_(src)

    def _run_fixed(self, X):
        """One dispatch of a (batch_size, C, H, W) float32 numpy batch."""
        with torch.inference_mode():
            x = torch.from_numpy(X).to(self.device)
            return self.network._test_fn(x).cpu().numpy()

    def predict_probs(self, X):
        """X: (N, C, H, W) any N — padded internally to full batches of the
        runner's batch size; returns (N, num_classes) numpy softmax scores."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        N = X.shape[0]
        B = self.batch_size
        if N == 0:
            # one all-zero batch gives the result's width
            return self._run_fixed(np.zeros((B,) + X.shape[1:], np.float32))[:0]
        outs = []
        for i in range(0, N, B):
            chunk, pad = self._pad_to_batch(X[i:i + B])
            probs = self._run_fixed(chunk)
            outs.append(probs[:-pad] if pad else probs)
        return np.concatenate(outs, axis=0)

    def predict(self, X):
        """Top-1 class ids, (N,) int."""
        return self.predict_probs(X).argmax(axis=1)

    def _pad_to_batch(self, X):
        n = X.shape[0]
        if n > self.batch_size:
            raise ValueError(
                "batch of {} exceeds the runner's batch_size {} — use "
                "predict_probs for arbitrary N (it chunks)".format(
                    n, self.batch_size))
        if n == self.batch_size:
            return X, 0
        pad = self.batch_size - n
        return np.concatenate(
            [X, np.zeros((pad,) + X.shape[1:], np.float32)]), pad

    def predict_iter(self, batches):
        """Stream (X, ...) batches (e.g. a loader's pull_batch); yields
        (probs, *rest) per batch, ``rest`` as ``device_prefetch`` placed it.
        Ragged batches are padded to the runner's batch and sliced back. On
        the card the inputs go up through a pinned ring two batches ahead,
        and a batch's probabilities come back through pinned buffers while
        the next batch is dispatched: each batch is yielded once the next one
        has been queued."""
        from dorknet_tpu_torch.data_loading.prefetch import PinnedRing, device_prefetch

        def padded():
            for b in batches:
                X, pad = self._pad_to_batch(np.asarray(b[0], np.float32))
                yield (X, pad) + tuple(b[1:])

        ring_in = ring_out = None
        if self.device.type == "cuda":
            ring_in, ring_out = PinnedRing(_PREFETCH + 1), PinnedRing(_PROBS_SLOTS)
            self.pinned_rings = (ring_in, ring_out)

        def to_host(probs):
            """(slot, host tensor): on the card a non-blocking copy into a
            slot of the probs ring."""
            if ring_out is None:
                return None, probs
            slot = ring_out.acquire()
            host = ring_out.view(slot, 0, probs.dtype, probs.shape)
            host.copy_(probs, non_blocking=True)
            ring_out.release(slot, self.device)
            return slot, host

        def done(slot, host, pad, rest):
            with span("runner.answer"):
                if slot is not None:
                    ring_out.wait(slot)
                return (host.numpy()[:host.shape[0] - pad].copy(),) + rest

        pending = None
        for X, pad, *rest in device_prefetch(padded(), size=_PREFETCH, device=self.device,
                                             ring=ring_in):
            with torch.inference_mode():
                with span("runner.forward"):
                    probs = self.network._test_fn(X)
                with span("runner.fetch"):
                    slot, host = to_host(probs)
            if pending is not None:
                yield done(*pending)
            pending = (slot, host, pad, tuple(rest))
        if pending is not None:
            yield done(*pending)

    def export_program(self, input_hw, channels=3, path=None, polymorphic_batch=False):
        """Serialise the serving program, the test-mode forward of the served
        copy (folded when the runner folds), as a ``torch.export`` program
        with the current parameters and running statistics in it, traced
        under the compute dtype set now. Every depthwise layer is a call of
        the registered op ``dorknet::depthwise3x3``, so the reloaded program
        runs the hand-written kernel.

        input_hw: the spatial size the program is specialised to.
        polymorphic_batch=True exports with a symbolic batch (any size from
        1) instead of the runner's batch. Returns the bytes; also writes
        ``path`` when given, with a ``<path>.meta.json`` sidecar (shapes,
        dtypes, platforms; informational, not needed to load). Reload with
        ``load_serving_program`` or ``load_serving_artifact``, which need
        torch and the op's registration but no model code. The program runs
        on the runner's device: there is no cross-device export."""
        x = torch.zeros((self.batch_size, int(channels)) + tuple(int(d) for d in input_hw),
                        dtype=torch.float32, device=self.device)
        dynamic = ({0: torch.export.Dim("batch", min=1)},) if polymorphic_batch else None
        with torch.no_grad():
            exported = torch.export.export(_TestForward(self.network), (x,),
                                           dynamic_shapes=dynamic, strict=False)
        # torch.export.save would store the example input beside the weights
        # (38.9 MB at batch 64 and 225 px, six times ResNet18's parameters)
        exported.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        blob = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
            meta = dict(describe(exported), runner=type(self).__name__)
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f, indent=2)
        return blob
