"""Batched inference runner — the serving path (counterpart of
``dorknet_tpu/network/inference.py``).

Every dispatch runs one fixed batch shape: ragged tails are padded with
zeros and sliced off, so each kernel sees the same shapes on every call. The
runner serves a snapshot, as the JAX runner means to (it gathers parameters
and states at construction and again in ``refresh()``): its own copy of the
caller's network on the runner's device (the card unless the caller asks
for the CPU), which training the caller's network does not change until
``refresh()``. The
caller's network stays where it was and as it was. Each batch is copied to
the device, run under ``torch.inference_mode()``, and the probabilities come
back as numpy. BN folding, ``predict_iter`` and program export come with a
later slice.
"""

import copy

import numpy as np
import torch

from dorknet_tpu_torch.layers.base import Layer


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


class InferenceRunner:
    def __init__(self, network, batch_size, device="cuda", fold_bn=False):
        """device: where the runner serves, the card by default. It serves
        its own copy of ``network`` there (``self.network``); ``network``
        itself is kept as the source of ``refresh()``."""
        if fold_bn:
            raise NotImplementedError(
                "fold_bn is not ported yet; build the runner with fold_bn=False")
        network._require_bn_initialized("InferenceRunner")
        self.device = resolve_device(device, "InferenceRunner")
        self._source = network
        self.network = _snapshot(network, self.device)
        self.batch_size = int(batch_size)

    def refresh(self):
        """Copy the source network's current parameters and batch-norm
        running statistics into the served copy, in place (no second copy
        is allocated on the device): the counterpart of the JAX runner's
        re-gathering after further training of the source."""
        pairs = [(self.network.parameters(), self._source.parameters()),
                 (self.network.buffers(), self._source.buffers())]
        with torch.no_grad():
            for served, source in pairs:
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
