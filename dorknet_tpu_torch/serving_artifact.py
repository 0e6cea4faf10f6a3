"""Serving artifacts: load what ``InferenceRunner.export_program`` wrote
(counterpart of ``load_serving_program``, ``ServingArtifact`` and
``load_serving_artifact`` in ``dorknet_tpu/network/inference.py``).

An artifact is a ``torch.export`` program (``torch.export.save``) of the
runner's test-mode forward, with its weights and running statistics in it.
Loading it needs torch and the registration of the two custom ops such a
program calls, ``dorknet::depthwise3x3`` (the hand-written depthwise
forward, ``ops/cuda/depthwise.py``) and ``dorknet::bias_act`` (a biased
layer's bias add and the activation after it, ``ops/cuda/bias_act.py``),
which this module imports; it imports nothing of the model zoo, the layers,
the network or the checkpoints. (The JAX package's artifacts need only jax:
their StableHLO carries its Pallas kernel inside.) A program runs on the
device it was exported on: there is no cross-device export.
"""

import io

import numpy as np
import torch

# register dorknet::bias_act and dorknet::depthwise3x3, which the exported
# graphs call
import dorknet_tpu_torch.ops.cuda.bias_act  # noqa: F401
import dorknet_tpu_torch.ops.cuda.depthwise  # noqa: F401

FORMAT = "torch.export"


def _blob(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def deserialize(path_or_bytes):
    """The ``torch.export.ExportedProgram`` of an artifact (a path or its
    bytes)."""
    return torch.export.load(io.BytesIO(_blob(path_or_bytes)))


def signature(exported):
    """(input value, output value) of an exported program: the fake tensors
    of its one user input and its one user output; a symbolic batch is a
    ``torch.SymInt``."""
    sig = exported.graph_signature
    nodes = {n.name: n for n in exported.graph.nodes}
    (inp,) = sig.user_inputs
    (out,) = sig.user_outputs
    return nodes[inp].meta["val"], nodes[out].meta["val"]


def _static(shape):
    return [None if isinstance(d, torch.SymInt) else int(d) for d in shape]


def describe(exported):
    """The input and output shapes, dtypes and device of a program, in the
    ``<path>.meta.json`` sidecar's keys (None for a symbolic batch)."""
    x, y = signature(exported)
    return {
        "format": FORMAT,
        "input_shape": _static(x.shape),
        "input_dtype": str(x.dtype).replace("torch.", ""),
        "output_avals": [{"shape": _static(y.shape),
                          "dtype": str(y.dtype).replace("torch.", "")}],
        "platforms": [x.device.type],
        "polymorphic_batch": isinstance(x.shape[0], torch.SymInt),
    }


def _runner(exported):
    """The exported forward as a callable module on its device, run without
    autograd."""
    x, _ = signature(exported)
    module = exported.module().to(x.device)

    def call(X):
        with torch.inference_mode():
            return module(torch.as_tensor(X, dtype=torch.float32, device=x.device))

    return call, x


def load_serving_program(path_or_bytes):
    """Reload a program written by ``InferenceRunner.export_program`` as a
    plain callable ``(B, C, H, W) float32 -> (B, num_classes) probs`` (a
    tensor on the export device; numpy or a tensor in)."""
    return _runner(deserialize(path_or_bytes))[0]


class ServingArtifact:
    """A reloaded ``export_program`` artifact with the live runner's host
    conveniences: arbitrary-N ``predict_probs`` (padding and chunking to the
    exported batch, the protocol of ``InferenceRunner.predict_probs``) and
    shape introspection.

    Polymorphic artifacts chunk ``predict_probs`` inputs to ``max_batch``
    rows a dispatch, with no padding (the batch is symbolic): an eval-sized
    input must not go to the card as one giant batch."""

    def __init__(self, exported, max_batch=256):
        self._call, x = _runner(exported)
        _, y = signature(exported)
        b = x.shape[0]
        self.polymorphic_batch = isinstance(b, torch.SymInt)
        self.batch_size = None if self.polymorphic_batch else int(b)
        self.max_batch = int(max_batch)
        self.input_shape = tuple(int(d) for d in x.shape[1:])
        self.device = x.device
        self.platforms = (x.device.type,)
        self.num_classes = int(y.shape[-1])

    def __call__(self, x):
        """Raw dispatch of one batch (numpy or a tensor; a fixed artifact
        takes exactly its batch). Returns a tensor on the artifact's device."""
        return self._call(x)

    def _host(self, X):
        return self._call(np.ascontiguousarray(X)).cpu().numpy()

    def predict_probs(self, X):
        """X: (N, C, H, W), any N — returns (N, num_classes) numpy scores."""
        X = np.asarray(X, dtype=np.float32)
        if X.shape[0] == 0:
            return np.zeros((0, self.num_classes), np.float32)
        if self.polymorphic_batch:
            B = self.max_batch
            return np.concatenate([self._host(X[i:i + B])
                                   for i in range(0, X.shape[0], B)], axis=0)
        B = self.batch_size
        outs = []
        for i in range(0, X.shape[0], B):
            chunk = X[i:i + B]
            pad = B - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            probs = self._host(chunk)
            outs.append(probs[:-pad] if pad else probs)
        return np.concatenate(outs, axis=0)

    def predict(self, X):
        """Top-1 class ids, (N,) int."""
        return self.predict_probs(X).argmax(axis=1)


def load_serving_artifact(path_or_bytes, max_batch=256):
    """Load an ``export_program`` artifact as a :class:`ServingArtifact`
    (``load_serving_program`` gives the bare callable). ``max_batch`` caps
    the rows of a dispatch of a polymorphic artifact's ``predict_probs``."""
    return ServingArtifact(deserialize(path_or_bytes), max_batch=max_batch)
