"""The port's spans: ranges of the PyTorch profiler at the layer boundaries
of the training step and the served stream.

``span(name)`` is a profiler range ``dorknet.<name>`` while
``torch.profiler`` records on this process, and otherwise one shared no-op
context, after a single check. The ranges live in the
profiler's own records: they carry the clock of its device records, come
out in its exporters (``export_chrome_trace``) and its event lists, and are
counted from there (the number of ``dorknet.trainer.replay`` ranges is the
number of replays). The program keeps no record of its own.

A range is a function-scope record (``_RecordFunctionFast``, a host
operation in the trace), not ``torch.profiler.record_function``'s user
annotation: the profiler copies each user annotation onto the card's
timeline over the kernels launched inside it, and where its events do not
give their activity type (torch 2.11 on an H100 host) a reader of the
device records cannot tell those copies from kernels.

``_RecordFunctionFast`` and ``torch.autograd._profiler_enabled`` are private
torch symbols, imported when this module is: checked in torch 2.11 (CUDA)
and 2.13 (CPU), and asserted by ``tests/test_torch_tracing.py``.

The spans, by the module that opens them:

- ``network/trainer.py``: ``trainer.step`` (each step entry), ``trainer.rows``
  (host rows of ``step_augmented_indexed`` to a tensor, range-checked),
  ``trainer.key`` (state, signature and graph lookup), ``trainer.eager``,
  ``trainer.capture``, and in a replay ``trainer.stage`` (pinned staging and
  input copies), ``trainer.replay`` (the graph launch) and
  ``trainer.outputs`` (the output clones);
- ``data_loading/prefetch.py``: ``ring.wait`` (a pinned slot whose copies
  are still in flight; only waits that block) and ``prefetch.stage`` (one
  batch into pinned memory and its upload queued);
- ``network/inference.py``: in ``predict_iter``, ``runner.forward`` (one
  batch's forward queued), ``runner.fetch`` (its probabilities' copy back
  queued) and ``runner.answer`` (the previous batch's probabilities waited
  for and unpacked);
- ``optimisers/AdamW.py``: ``adamw.update`` (the update's launches, in an
  eager step and in a capture; a replay runs no host code).
"""

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()

# True while torch.profiler records (one C++ call)
recording = torch.autograd._profiler_enabled


def span(name):
    """A context manager: the profiler range ``dorknet.<name>`` while the
    profiler records, else the shared no-op context."""
    if recording():
        return _RecordFunctionFast("dorknet." + name)
    return _OFF
