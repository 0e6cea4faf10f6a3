"""The system under test, built from a configuration: the program's network
with the benchmark's weights, in the configuration's precision."""

import gc

import torch

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import weights


def network(cell, params, stats, device):
    """The configuration's network of the program, on ``device``, holding
    ``params`` and ``stats``. Returns (network, {name: its parameter})."""
    net = cells.program_model(cell).to(device)
    placed = weights.load_into(net, params, stats)
    return net, placed


def set_precision(precision, control=None):
    """The program's precision as the configuration states it
    (``{"compute_dtype": "float32", "tf32": false}``), or the program's
    own path one step below it under ``control`` ("bf16")."""
    from dorknet_tpu_torch import config

    dtype = getattr(torch, precision["compute_dtype"])
    if control == "bf16":
        if dtype != torch.float32:
            raise ValueError("the bf16 control is the step below float32, not below "
                             + precision["compute_dtype"])
        dtype = torch.bfloat16
    elif control is not None:
        raise ValueError("unknown control {!r}".format(control))
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(precision["tf32"])
    config.set_compute_dtype(dtype)


def release(device):
    """Give the program's memory back once its objects are dropped, so the
    reference runs in what it frees, and give the reference its precision:
    plain fp32 with TF32 off, whatever the program ran in."""
    from dorknet_tpu_torch import config

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.set_compute_dtype(torch.float32)
