"""One run of one cell: its loop's set-up, window and checks, then the
result line."""

import json
import math
import sys

import torch

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import checks, device as cards, program
from benchmark_torch.harness.record import Record


def run_cell(workload, seed, seconds, trace, t0, device="cuda", control=None, fault=None,
             overrides=None):
    """Returns (result dict, stderr check lines). ``device`` "cpu" skips the
    look for a card (the benchmark's own tests, at a test's size)."""
    cell = cells.load(workload, overrides)
    device = torch.device(device)
    program.set_precision(cell.config["precision"], control)
    rec = Record(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                 device=device, t0=t0, control=control, fault=fault)
    rec.mark("torch and the program imported")
    cells.loop(cell).run(rec)
    if device.type == "cuda":
        rec.note("card after the window (name, power limit, draw, SM clock, temperature):",
                 cards.card_query())
    limits = checks.load_limits(cell.name)
    ok, entry, lines = checks.verdict(rec.checks, limits)
    if rec.failed:
        lines.append("failed: {} of {} attempted".format(rec.failed, rec.attempted))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = (rec.layer_values if trace else rec.e2e).get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(cards.describe(device), memory_peak_bytes=rec.memory_peak)
    result = {"correct": bool(ok and rec.failed == 0), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace and rec.slice is not None:
        dev["busy_s"] = rec.slice.busy_s
        dev["window_s"] = rec.slice.window_s
        result["breakdown"] = rec.slice.breakdown()
    result["checks"] = entry
    return result, lines


def emit(result, lines):
    """The result as the last line of standard output, the compared numbers
    as the last lines of standard error."""
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)


def _finite(obj):
    """The result with every non-finite number written as a string."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj
