"""The card: the check for it, its description, and the caches kept inside
the checkout."""

import os
import subprocess
import sys

from benchmark_torch.harness.cell import ROOT

# fixed paths inside the checkout: only a checkout's first run builds
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "triton-cache",
              "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch-extensions"}


def set_cache_dirs():
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)


def require_cards(count):
    """Exit non-zero, with no result, unless ``count`` CUDA cards are
    there."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < count:
        sys.exit("benchmark: the cell needs {} cards, {} found".format(
            count, torch.cuda.device_count()))


def card_query():
    """nvidia-smi's name, power limit, power draw, SM clock and temperature
    of card 0, or why there is none."""
    fields = "name,power.limit,power.draw,clocks.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=" + fields, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return "nvidia-smi unavailable ({})".format(type(err).__name__)


def describe(device):
    """The result's ``device`` entry, without the peak."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def memory_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0
