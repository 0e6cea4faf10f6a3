"""Torch-native checkpoints of a training run (counterpart of
``dorknet_tpu/utils/orbax_io.py``): the parameters, the batch-norm running
statistics, the trainer's optimiser state and its EMA shadow, in one file
written by ``torch.save`` from CPU tensors and read by
``torch.load(weights_only=True)``. It needs no h5py, which the card's
machine lacks; the reference's h5+json format stays the interchange format
(``FeedForwardNetwork.save_weights_to_h5``).

The file holds a dict with the keys of the JAX package's ``_state_tree``:

* ``params``: one entry per layer in the shape of ``get_params()``;
* ``states``: one entry per layer in the shape of ``get_state()``, with
  None for the statistics of a batch norm that was unset;
* ``opt_cache`` (given a trainer that has optimiser state): the trainer's
  cache, a list of tensors in ``network.parameters()`` order (``AdamW``'s:
  the first moments, the second moments, then its 0-dim step count);
* ``ema`` (given a trainer that keeps one): the shadow, in the same order.

``load_checkpoint`` restores in place: it copies into the live parameters,
running statistics, optimiser cache and EMA (``copy_``), so the captured
CUDA graphs of a trainer, which read those tensors by address, replay the
restored state without a new capture. A batch norm that the file sets and
the network has unset takes new tensors; batch-norm state is in a graph's
key, so the next step captures anew. What the file lacks stays as it is:
without an optimiser cache the trainer keeps its own; without an EMA the
trainer keeps its shadow, or, having none yet, starts it from the restored
parameters at its next step; a batch norm unset when the file was written
keeps the network's statistics.
"""

import concurrent.futures
import os

import torch

from dorknet_tpu_torch.layers.batch_norm import BatchNormLayer
from dorknet_tpu_torch.layers.residual_block import ResidualBlock

FORMAT = "dorknet-torch-checkpoint-v1"


def _host(t):
    """A CPU copy of tensor t. For a tensor on the card the copy waits for
    the work queued before it, so it holds the values at the call."""
    return t.detach().to("cpu", copy=True)


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return None if tree is None else _host(tree)


def _live_states(layer):
    """The running statistics of ``layer`` (and its children) in the shape
    of ``get_state()``: the live tensors, None where a batch norm is unset."""
    if isinstance(layer, BatchNormLayer):
        return {"running_mean": layer.running_mean, "running_std": layer.running_std}
    if isinstance(layer, ResidualBlock):
        return layer._tree(_live_states)
    return layer.get_state()


def state_tree(network, trainer=None):
    """The checkpoint's dict, every tensor a CPU copy of the live one."""
    tree = {"format": FORMAT,
            "params": [_host_tree(l.get_params()) for l in network.layers],
            "states": [_host_tree(_live_states(l)) for l in network.layers]}
    if trainer is not None and trainer._cache is not None:
        tree["opt_cache"] = [_host(t) for t in trainer._cache]
    if trainer is not None and trainer._ema is not None:
        tree["ema"] = [_host(t) for t in trainer._ema]
    return tree


def _write(tree, path):
    """torch.save to a temporary name, then rename: a reader never finds a
    half-written file at ``path``."""
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path, network, trainer=None):
    """Save the parameters and running statistics, and the optimiser cache
    and EMA when a trainer is given. Returns the absolute path."""
    return _write(state_tree(network, trainer), os.path.abspath(path))


class AsyncCheckpointer:
    """Writes checkpoints on one background thread. ``save`` takes the host
    copies before it returns, so the steps that follow cannot change what
    is written, and first waits for a write still in flight: training
    overlaps one write at a time."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-writer")
        self._pending = None

    def save(self, path, network, trainer=None):
        self.wait_until_finished()
        tree = state_tree(network, trainer)
        self._pending = self._pool.submit(_write, tree, os.path.abspath(path))
        return self

    def wait_until_finished(self):
        """Block until the last write is on disk; raise its error if it
        failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()


_ASYNC_CKPTR = None


def save_checkpoint_async(path, network, trainer=None):
    """Non-blocking ``save_checkpoint`` through one shared
    ``AsyncCheckpointer``, which it returns: call ``wait_until_finished()``
    on it before reading the file or leaving the process."""
    global _ASYNC_CKPTR
    if _ASYNC_CKPTR is None:
        _ASYNC_CKPTR = AsyncCheckpointer()
    return _ASYNC_CKPTR.save(path, network, trainer)


def _copy(dst, src, what):
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError("{}: the network has shape {}, the checkpoint {}".format(
            what, tuple(dst.shape), tuple(src.shape)))
    dst.copy_(src)


def _copy_tree(live, saved, what):
    if isinstance(live, dict):
        if set(live) != set(saved):
            raise ValueError("{}: the network has {}, the checkpoint {}".format(
                what, sorted(live), sorted(saved)))
        for k in live:
            _copy_tree(live[k], saved[k], "{}/{}".format(what, k))
    elif isinstance(live, list):
        if len(live) != len(saved):
            raise ValueError("{}: the network has {} entries, the checkpoint {}".format(
                what, len(live), len(saved)))
        for i, (a, b) in enumerate(zip(live, saved)):
            _copy_tree(a, b, "{}[{}]".format(what, i))
    else:
        _copy(live, saved, what)


def _restore_states(layer, saved):
    if isinstance(layer, BatchNormLayer):
        if saved["running_mean"] is not None:
            layer.set_state(saved)  # in place once set
    elif isinstance(layer, ResidualBlock):
        layer._set(saved, _restore_states)


def load_checkpoint(path, network, trainer=None):
    """Restore a ``save_checkpoint`` file into an already built network of
    the same structure (and into ``trainer``'s optimiser cache and EMA when
    one is given and the file holds them), in place. Returns the network."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if tree.get("format") != FORMAT:
        raise ValueError("{} is not a {} file".format(path, FORMAT))
    if len(tree["params"]) != len(network.layers):
        raise ValueError("{}: the network has {} layers, the checkpoint {}".format(
            path, len(network.layers), len(tree["params"])))
    with torch.no_grad():
        for layer, p, s in zip(network.layers, tree["params"], tree["states"], strict=True):
            _copy_tree(layer.get_params(), p, layer.layer_name)
            _restore_states(layer, s)
        if trainer is not None:
            _restore_trainer(trainer, tree)
    return network


def _restore_trainer(trainer, tree):
    params = list(trainer.network.parameters())
    if "opt_cache" in tree:
        if trainer._cache is None or trainer._cache_owner is not trainer.optimiser:
            # the graphs of another optimiser's state are stale (as in
            # Trainer._prepare)
            trainer._cache = trainer.optimiser.init_cache(params)
            trainer._graphs.clear()
        _copy_tree(trainer._cache, tree["opt_cache"], "opt_cache")
        # the cache is this optimiser's: the first step must not make it anew
        trainer._cache_owner = trainer.optimiser
    if "ema" in tree and trainer.ema_decay is not None:
        if trainer._ema is None:
            trainer._ema = [p.detach().clone() for p in params]
        _copy_tree(trainer._ema, tree["ema"], "ema")
