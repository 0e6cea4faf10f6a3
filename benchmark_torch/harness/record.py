"""What one run gathers: the cell and its arguments, the end-to-end numbers,
the spans and counters, the profiled slice, the numbers compared, and the
handles the per-layer readers use while the program is still alive."""

import sys
import time
from dataclasses import dataclass, field

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness.timing import Spans


@dataclass
class Record:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                 # process start, perf_counter seconds
    control: str = None       # "bf16": the program's lower-precision path
    fault: str = None         # a planted fault (the benchmark's own tests)
    spans: Spans = field(default_factory=Spans)
    e2e: dict = field(default_factory=dict)        # end-to-end metric -> value
    checks: dict = field(default_factory=dict)     # compared number -> value
    attempted: int = 0
    failed: int = 0
    # what the readers read
    layers: list = None       # the reference's layer table at the timed batch
    window: tuple = None      # (start, end) of the measured window, perf_counter
    images: int = 0           # images the window completed
    counters: dict = field(default_factory=dict)
    slice: object = None      # trace.Slice of the profiled slice
    handles: dict = field(default_factory=dict)    # program objects for kernel timing
    layer_values: dict = field(default_factory=dict)
    memory_peak: int = 0

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def mark(self, what):
        """A milestone of set-up, in seconds since the process started."""
        self.note("set-up {:.4f} s: {}".format(time.perf_counter() - self.t0, what))

    def note(self, *parts):
        """A line on standard error, before the result."""
        print("[{}]".format(self.cell.name), *parts, file=sys.stderr, flush=True)

    def read_layers(self):
        """Run every per-layer reader of the cell (traced runs only); a
        reader that finds nothing returns None and its metric is left out."""
        if not self.trace:
            return
        for metric in self.cell.per_layer:
            value = cells.reader(metric["name"])(self)
            if value is not None:
                self.layer_values[metric["name"]] = float(value)
