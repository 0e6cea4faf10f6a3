"""The port's spans (``utils/tracing.span``) on the CPU.

- With no profiler recording, ``span`` hands back one shared no-op context
  and a trainer step or a ``predict_iter`` pass makes no profiler range.
- Under ``torch.profiler`` each step entry opens one ``trainer.step``
  range holding ``trainer.key`` and ``trainer.eager`` (eager on the CPU),
  ``step_augmented_indexed`` adds ``trainer.rows``, and ``predict_iter``
  over N batches gives N ``prefetch.stage``, ``runner.forward``,
  ``runner.fetch`` and ``runner.answer`` ranges.
- A ``PinnedRing`` wait opens ``ring.wait`` only when it blocks, and tests
  its event only while the profiler records.
- The two private torch symbols that ``tracing`` imports exist.
- AdamW's update opens one ``adamw.update`` range a step, inside
  ``trainer.eager``, and ``layer_norm.launches_by_layout`` counts a
  ConvNeXt step's LayerNorms by layout.

The captured step's ranges (``trainer.stage``, ``trainer.replay``,
``trainer.outputs``, ``trainer.capture``) and a blocking wait on a real
CUDA event are checked on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch import layers as L  # noqa: E402
from dorknet_tpu_torch.data_loading.prefetch import PinnedRing  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, InferenceRunner, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import AdamW, SGDMomentum  # noqa: E402
from dorknet_tpu_torch.utils import tracing  # noqa: E402

AUG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)), rotation_tuple=(-15.0, 15.0),
           horizontal_flip_prob=0.5, crop_mode="random", mixup=(0.0, 0.3))


def _net():
    np.random.seed(61)
    net = FeedForwardNetwork("traced")
    net.add_layer(L.ConvLayer("conv0", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn0", incoming_chans=8))
    net.add_layer(L.ReLu("relu0"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=3))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def _trainer():
    net = _net()
    return Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu")


def _data(seed, B=4, hw=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(2, B, 3, hw, hw).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, B))]
    images = torch.from_numpy(rng.randint(0, 256, (12, 20, 20, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, 3, 12)).int()
    rows = rng.randint(0, 12, (2, B))
    return X, y, images, labels, rows


def _call(trainer, entry, seed=62):
    """One call of a step entry on small inputs; returns the number of
    steps it takes."""
    X, y, images, labels, rows = _data(seed)
    gen = torch.Generator().manual_seed(seed)
    if entry == "step":
        trainer.step(X[0], y[0])
    elif entry == "multi_step":
        trainer.multi_step(X, y)
        return 2
    elif entry == "accumulate_step":
        trainer.accumulate_step(X, y)
    elif entry == "step_augmented":
        trainer.step_augmented(gen, images[:4].numpy(), y[0], (16, 16), **AUG)
    elif entry == "step_augmented_indexed":
        trainer.step_augmented_indexed(gen, images, labels, rows[0], (16, 16), 3, **AUG)
    elif entry == "multi_step_augmented_indexed":
        trainer.multi_step_augmented_indexed(gen, images, labels, rows, (16, 16), 3, **AUG)
        return 2
    return 1


def _ranges(prof):
    """[(name without the prefix, start ns, end ns)] of the port's ranges,
    in start order. Each is a host operation, not a user annotation (which
    the profiler would copy onto the card's timeline)."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("dorknet.")]
    assert all(e.device_type() == torch.autograd.DeviceType.CPU and not e.is_user_annotation()
               for e in events)
    out = [(e.name()[len("dorknet."):], e.start_ns(), e.end_ns()) for e in events]
    return sorted(out, key=lambda r: r[1])


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _ranges(prof)


def _names(ranges):
    return [n for n, _, _ in ranges]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _serve(n_batches):
    runner = InferenceRunner(_trained_net(), batch_size=4, device="cpu")
    X = list(np.random.RandomState(63).randn(n_batches, 4, 3, 12, 12).astype(np.float32))
    X[-1] = X[-1][:3]  # a ragged last batch, padded and sliced back
    return lambda: list(runner.predict_iter((x, k) for k, x in enumerate(X)))


def _trained_net():
    trainer = _trainer()
    _call(trainer, "step")
    return trainer.network


@pytest.mark.parametrize("module, name", [("torch._C._profiler", "_RecordFunctionFast"),
                                          ("torch.autograd", "_profiler_enabled")])
def test_private_torch_symbols_the_spans_use(module, name):
    import importlib
    assert hasattr(importlib.import_module(module), name), (
        f"utils/tracing.py needs {module}.{name}, which this torch build lacks")


def test_no_profiler_no_ranges(monkeypatch):
    assert not tracing.recording()
    assert tracing.span("trainer.step") is tracing.span("runner.answer")
    made = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast", lambda name: made.append(name))
    trainer = _trainer()
    for entry in ("step", "step_augmented_indexed", "accumulate_step"):
        _call(trainer, entry)
    out = _serve(3)()
    assert len(out) == 3 and out[-1][0].shape == (3, 3)
    assert made == []


@pytest.mark.parametrize("entry", ["step", "multi_step", "accumulate_step", "step_augmented",
                                   "step_augmented_indexed", "multi_step_augmented_indexed"])
def test_each_step_entry_opens_one_step_range_a_step(entry):
    trainer = _trainer()
    _call(trainer, entry, seed=64)  # the first call adopts the batch statistics
    steps = []
    ranges = _profiled(lambda: steps.append(_call(trainer, entry, seed=65)))
    outer = [r for r in ranges if r[0] == "trainer.step"]
    assert len(outer) == steps[0]
    for step in outer:
        inner = [r for r in ranges if r is not step and _inside(r, step)]
        names = _names(inner)
        assert names.count("trainer.key") == 1 and names.count("trainer.eager") == 1
        key = next(r for r in inner if r[0] == "trainer.key")
        eager = next(r for r in inner if r[0] == "trainer.eager")
        assert key[2] <= eager[1], "the graph key is made before the step runs"
        assert names.count("trainer.rows") == ("indexed" in entry)
    assert not {"trainer.replay", "trainer.stage", "trainer.outputs", "trainer.capture",
                "ring.wait"} & set(_names(ranges))


def test_cpu_tensor_rows_open_the_rows_span_and_are_checked():
    """Rows given as a CPU tensor take the range check too, inside
    ``trainer.rows``."""
    trainer = _trainer()
    _, _, images, labels, rows = _data(66)
    gen = torch.Generator().manual_seed(66)
    ranges = _profiled(lambda: trainer.step_augmented_indexed(
        gen, images, labels, torch.from_numpy(rows[0]), (16, 16), 3, **AUG))
    assert _names(ranges).count("trainer.rows") == 1
    with pytest.raises(IndexError):
        trainer.step_augmented_indexed(gen, images, labels, [0, 12], (16, 16), 3, **AUG)


@pytest.mark.parametrize("n_batches", [1, 3])
def test_predict_iter_opens_each_range_once_a_batch(n_batches):
    ranges = _profiled(_serve(n_batches))
    names = _names(ranges)
    for name in ("prefetch.stage", "runner.forward", "runner.fetch", "runner.answer"):
        assert names.count(name) == n_batches, name
    assert "ring.wait" not in names  # the CPU stream pins nothing
    forwards = [r for r in ranges if r[0] == "runner.forward"]
    fetches = [r for r in ranges if r[0] == "runner.fetch"]
    answers = [r for r in ranges if r[0] == "runner.answer"]
    for f, g, a in zip(forwards, fetches, answers, strict=True):
        assert f[2] <= g[1] <= a[1], "a batch is queued, fetched, then answered"


class _Event:
    """A stand-in for a CUDA event: done or still running."""

    def __init__(self, done):
        self.done, self.synchronized, self.queried = done, False, False

    def query(self):
        self.queried = True
        return self.done

    def synchronize(self):
        self.synchronized = True


@pytest.mark.parametrize("done", [False, True], ids=["blocks", "ready"])
def test_ring_wait_range_only_for_a_wait_that_blocks(done):
    ring = PinnedRing(2)
    event = ring._events[0] = _Event(done)
    ranges = _profiled(lambda: ring.acquire())
    assert _names(ranges) == ([] if done else ["ring.wait"])
    assert event.synchronized and ring._events[0] is None
    untraced = ring._events[0] = _Event(done)
    ring.wait(0)
    assert untraced.synchronized and not untraced.queried


@pytest.mark.parametrize("entry", ["step", "multi_step", "accumulate_step"])
def test_adamw_opens_one_update_range_a_step(entry):
    net = _net()
    trainer = Trainer(net, AdamW(net, 1e-3), device="cpu")
    _call(trainer, entry, seed=67)  # the first call adopts the batch statistics
    steps = []
    ranges = _profiled(lambda: steps.append(_call(trainer, entry, seed=68)))
    updates = [r for r in ranges if r[0] == "adamw.update"]
    eager = [r for r in ranges if r[0] == "trainer.eager"]
    assert len(updates) == len(eager) == steps[0]
    for update, step in zip(updates, eager, strict=True):
        assert _inside(update, step)
    assert float(trainer._cache[-1]) == 2 * steps[0]  # both calls took as many steps


def test_layer_norm_counts_a_convnext_steps_layer_norms_by_layout():
    """Two stages of one block: the stem's, the block's and the
    downsampling LayerNorms over NHWC, the head's over rows."""
    from dorknet_tpu_torch.models import ConvNeXt
    from dorknet_tpu_torch.ops.norm import layer_norm

    np.random.seed(69)
    net = ConvNeXt("traced", num_classes=3, depths=(1, 1), dims=(8, 16))
    trainer = Trainer(net, AdamW(net, 1e-3), device="cpu")
    X, y, *_ = _data(69, hw=32)
    before = dict(layer_norm.launches_by_layout)
    trainer.step(X[0], y[0])
    assert layer_norm.launches_by_layout == {"nhwc": before["nhwc"] + 4,
                                             "rows": before["rows"] + 1}
    assert not _names(_profiled(lambda: None))
    net.forward(X[0], test_mode=True)
    assert layer_norm.launches_by_layout == {"nhwc": before["nhwc"] + 8,
                                             "rows": before["rows"] + 2}
