"""Batched inference runner — the serving path (counterpart of
``dorknet_tpu/network/inference.py``).

Every dispatch runs one fixed batch shape: ragged tails are padded with
zeros and sliced off, so each kernel sees the same shapes on every call. The
network is moved to the runner's device once (the card unless the caller
asks for the CPU); each batch is copied there, run under
``torch.inference_mode()``, and the probabilities come back as numpy.
BN folding, ``predict_iter`` and program export come with a later slice.
"""

import numpy as np
import torch


def resolve_device(device, who):
    """torch.device(device); a CUDA device without a usable card raises, so
    an entry point never carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "{} runs on {} by default, but no CUDA device is available; pass "
            "device='cpu' to run on the CPU".format(who, device))
    return device


class InferenceRunner:
    def __init__(self, network, batch_size, device="cuda", fold_bn=False):
        """device: where the network runs, the card by default. The network
        is moved there in place."""
        if fold_bn:
            raise NotImplementedError(
                "fold_bn is not ported yet; build the runner with fold_bn=False")
        network._require_bn_initialized("InferenceRunner")
        self.device = resolve_device(device, "InferenceRunner")
        self.network = network.to(self.device)
        self.batch_size = int(batch_size)

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
