"""The numbers that decide ``correct``, each beside its limit.

A cell's limits live in ``limits/<workload>.json`` (name -> limit), with the
readings they were set from written in ``PERF.md``. A number above its
limit, a missing number, or a number that is not finite makes the run not
correct.
"""

import json
import math
import statistics

import torch

from benchmark_torch.harness.cell import BENCH_DIR


def load_limits(workload):
    return json.loads((BENCH_DIR / "limits" / (workload + ".json")).read_text())


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def worst_leaf(prog, ref):
    """The largest |norm(prog[leaf]) - norm(ref[leaf])| over the leaves,
    each measured against the larger of the reference's norm of that leaf
    and the median leaf's. ``prog`` and ``ref`` map leaf -> tensor or
    norm. Returns (gap, leaf)."""
    leaves = list(ref)
    rn = {k: ref[k] if isinstance(ref[k], float) else _norm(ref[k]) for k in leaves}
    pn = {k: prog[k] if isinstance(prog[k], float) else _norm(prog[k]) for k in leaves}
    floor = statistics.median(rn.values())
    worst, where = 0.0, None
    for k in leaves:
        gap = abs(pn[k] - rn[k]) / max(rn[k], floor)
        if not math.isfinite(gap) or gap > worst:
            worst, where = (gap if math.isfinite(gap) else math.inf), k
            if not math.isfinite(gap):
                break
    return worst, where


def moved(grads, rule=1e-3):
    """The leaves whose gradient norm is at least ``rule`` times the median
    leaf's: the others move under an adaptive update by round-off alone."""
    norms = {k: _norm(g) for k, g in grads.items()}
    floor = rule * statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= floor}


def verdict(checks, limits):
    """(correct, the checks entry of the result line, lines for stderr)."""
    entry, lines, ok = {}, [], True
    for name in limits:
        value = checks.get(name)
        limit = float(limits[name])
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        entry[name] = {"value": value if value is None or math.isfinite(value) else str(value),
                       "limit": limit}
        lines.append("check {}: {} (limit {}){}".format(name, value, limit,
                                                         "" if good else "  FAILED"))
    return ok, entry, lines
