"""The BN-fusion A/B harness on the CPU at a tiny shape: the three variants'
statistics agree inside the harness's 2e-2 gate (the fused ones come from
the fp32 product, the others from the stored bf16 y), and no device time is
reported without a card, by the harness or by ``measure_device_ms``."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch.utils import bn_fuse_ab  # noqa: E402
from dorknet_tpu_torch.utils.autotune import measure_device_ms  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [("tiny_16_32_s4", 4, 16, 32), ("ragged_24_40_s3", 3, 24, 40)]


def test_run_on_the_cpu_passes_its_gate():
    results = bn_fuse_ab.run(rounds=1, runs=1, batch=2, shapes=TINY, device="cpu")
    for name, *_ in TINY:
        assert results["{}_stats_ok".format(name)] is True
        fused = results["{}_cuda_fused_stats_rel_err".format(name)]
        split = results["{}_cuda_split_stats_rel_err".format(name)]
        # the split variant reads the same bf16 y as the torch variant
        assert 0 < fused < bn_fuse_ab.GATE and split <= 1e-6
    assert not any(k.endswith("_device_ms") or k.endswith("_speedup") for k in results)


def test_measure_device_ms_refuses_without_a_card(monkeypatch):
    """No device time exists on the CPU: the measurement raises instead of
    reporting a host time, and runs nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        measure_device_ms(lambda: calls.append(1))
    assert calls == []


def test_module_runs_as_a_script_and_refuses_without_a_card():
    """python -m dorknet_tpu_torch.utils.bn_fuse_ab runs on the card by
    default: without one it raises and names the CPU option; with --device
    cpu it prints the JSON results."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-m", "dorknet_tpu_torch.utils.bn_fuse_ab", "--rounds", "1",
           "--runs", "1", "--batch", "1"]
    no_card = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=300)
    assert no_card.returncode != 0 and "device='cpu'" in no_card.stderr
    cpu = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert cpu.returncode == 0, cpu.stderr
    results = json.loads(cpu.stdout)
    assert results["early_64_256_s56_stats_ok"] and results["deep_1024_256_s14_stats_ok"]
