"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix. The configuration's
file (``configs/<config>.json``, as ``BENCHMARK.json`` lists it) holds the
sizes and names the plain reference (``reference/<reference>.py``) and the
program's model; the mix's file (``traffic/<traffic>.json``) holds the
mix's parameters and names the loop that runs it (``loops/<loop>.py``).
A training mix names its feed (``feeds/<entry>.py``) and a configuration's
``train`` its optimiser (``optimisers/<optimiser>.py``). A per-layer metric
is read by ``metrics/<metric name>.py``. Nothing here needs an edit when a
cell, a mix, a feed, an optimiser or a metric is added.
"""

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # the cell's metric entries
    per_layer: list = field(default_factory=list)


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def _merged(base, over):
    """``base`` with the keys of ``over`` replaced, dicts merged key by key
    (the CPU tests' size overrides)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else v
    return out


def load(workload, overrides=None):
    """The cell called ``workload``. ``overrides`` ({"config": {...},
    "traffic": {...}}) replaces sizes, for runs at a test's size."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit("no workload {!r} in BENCHMARK.json (have: {})".format(
            workload, ", ".join(sorted(cells))))
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / (w["traffic"] + ".json")).read_text())
    overrides = overrides or {}
    return Cell(name=w["name"], chips=int(w["chips"]),
                config=_merged(config, overrides.get("config")),
                traffic=_merged(traffic, overrides.get("traffic")),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, w["name"])],
                per_layer=[m for m in bench["per_layer"] if _applies(m, w["name"])])


def loop(cell):
    return importlib.import_module("benchmark_torch.loops." + cell.traffic["loop"])


def feed(cell):
    """The ``Feed`` class of the training mix's ``entry``."""
    return importlib.import_module("benchmark_torch.feeds." + cell.traffic["entry"]).Feed


def optimiser(cell):
    """The module of the configuration's optimiser: the program's, the
    reference's update and the first gradient's reading."""
    return importlib.import_module("benchmark_torch.optimisers."
                                   + cell.config["train"]["optimiser"])


def reference(cell):
    return importlib.import_module("benchmark_torch.reference." + cell.config["reference"])


def program_model(cell):
    """A fresh network of the program, as the configuration names it."""
    module, cls = cell.config["program"]["model"].split(":")
    return getattr(importlib.import_module(module), cls)(cell.name,
                                                         **cell.config["program"]["kwargs"])


def reader(metric_name):
    """``read(record)`` of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / (metric_name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_torch.metrics." + metric_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
