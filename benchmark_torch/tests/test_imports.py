"""Importing the harness, its loops, references and readers pulls in no
JAX and no JAX package."""

import subprocess
import sys

from benchmark_torch.harness.cell import BENCH_DIR, ROOT

PROBE = """
import importlib, sys, pathlib
sys.path.insert(0, {root!r})
bench = pathlib.Path({bench!r})
import runpy
runpy.run_path(str(bench / "run.py"), run_name="not_main")
for sub in ("harness", "loops", "feeds", "optimisers", "reference", "work"):
    for f in sorted((bench / sub).glob("*.py")):
        importlib.import_module("benchmark_torch.{{}}.{{}}".format(sub, f.stem))
from benchmark_torch.harness.cell import reader
for f in sorted((bench / "metrics").glob("*.py")):
    reader(f.name[:-3])
import dorknet_tpu_torch.network, dorknet_tpu_torch.data_loading.device_augment
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "dorknet_tpu"
       or m.startswith("dorknet_tpu.") or m == "chip_smoke"]
print("BAD", bad)
"""


def test_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), bench=str(BENCH_DIR))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout


def test_no_result_without_a_card():
    """On a machine without CUDA the command exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "mnv3l.serve.bulk", "--seed", "2147483999", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT), env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
