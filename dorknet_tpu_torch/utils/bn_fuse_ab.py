"""A/B of the GEMM + batch-norm statistics pair: the fused CUDA epilogue
against two unfused schedules (counterpart of ``scripts/bn_fuse_ab.py`` and
``bench.py:bench_bn_fuse_check``).

A pointwise conv feeding a batch norm is a GEMM whose output the statistics
pass reads back. Three programs compute the same (y bf16, mean, var):

- ``torch``: ``torch.matmul`` in bf16, then the statistics re-read from the
  stored bf16 y, as the port's batch norm reads a stored activation;
- ``cuda_fused``: ``matmul_bn_stats``, the statistics taken in the GEMM's
  epilogue from the fp32 product, y written once and not read again;
- ``cuda_split``: ``torch.matmul`` then the one-pass ``batch_norm_stats``
  kernel, which isolates the epilogue's gain from the one-pass statistics'.

Beside them ``matmul`` alone (fp32 out) is timed, so the fused time can be
read against the hand-written GEMM without its epilogue.

Correctness gate, as the JAX harness's: the fused and split statistics are
within 2e-2 of the ``torch`` variant's, relative to the largest magnitude
(the fused ones come from the fp32 product, before y's bf16 rounding, so a
small systematic difference is expected). Timing: CUDA events, each
variant's best of ``rounds`` interleaved rounds, each the median of ``runs``
calls. The card runs it by default; on the CPU the gate runs and no time is
taken.

Usage: python -m dorknet_tpu_torch.utils.bn_fuse_ab [--rounds 3] [--runs 3]
"""

import argparse
import json
import sys
import time

import torch

from dorknet_tpu_torch.network.inference import resolve_device
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats
from dorknet_tpu_torch.ops.cuda.matmul import matmul, matmul_bn_stats
from dorknet_tpu_torch.utils.autotune import measure_device_ms

GATE = 2e-2

# (name, H, Cin, Cout) at batch 128, the JAX harness's shapes: ResNet-50's
# memory-bound early 1x1 (64 -> 256 at 56 px) and a deep 1x1 (1024 -> 256 at
# 14 px)
SHAPES = [
    ("early_64_256_s56", 56, 64, 256),
    ("deep_1024_256_s14", 14, 1024, 256),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _torch_pair(x, w):
    y = torch.matmul(x, w)
    yf = y.float()
    mean = yf.mean(dim=0)
    return y, mean, torch.clamp((yf * yf).mean(dim=0) - mean * mean, min=0.0)


def _split(x, w):
    y = torch.matmul(x, w)
    return (y, *batch_norm_stats(y))


VARIANTS = {
    "torch": _torch_pair,
    "cuda_fused": lambda x, w: matmul_bn_stats(x, w, out_dtype=torch.bfloat16),
    "cuda_split": _split,
}


def _rel_err(got, want):
    return float((got - want).abs().max() / max(1e-6, float(want.abs().max())))


def run(rounds=3, runs=3, batch=128, shapes=None, device="cuda"):
    """Returns a flat dict, the JAX harness's keys with ``xla`` named
    ``torch`` and ``pallas_*`` named ``cuda_*``: per shape the fused and
    split variants' ``*_stats_rel_err``, ``*_stats_ok``, and on the card each
    variant's ``*_device_ms`` (also ``cuda_matmul``) and the
    ``*_fused_speedup`` of torch over fused."""
    device = resolve_device(device, "bn_fuse_ab")
    results = {}
    for name, H, cin, cout in (shapes or SHAPES):
        M = batch * H * H
        g = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((M, cin), generator=g, device=device).to(torch.bfloat16)
        w = torch.randn((cin, cout), generator=g, device=device).to(torch.bfloat16) * 0.05

        outs = {}
        for vname, fn in VARIANTS.items():
            t0 = time.perf_counter()
            _, mean, var = fn(x, w)
            outs[vname] = (mean, var)
            log("{} {}: first call {:.2f} s".format(name, vname, time.perf_counter() - t0))
        ref_m, ref_v = outs["torch"]
        ok = True
        for vname in ("cuda_fused", "cuda_split"):
            m, v = outs[vname]
            err = max(_rel_err(m, ref_m), _rel_err(v, ref_v))
            ok = ok and err < GATE
            results["{}_{}_stats_rel_err".format(name, vname)] = err
        results["{}_stats_ok".format(name)] = bool(ok)

        if device.type != "cuda":
            log("{}: no device time on {}".format(name, device))
            continue
        timed = dict(VARIANTS, cuda_matmul=matmul)
        dev = {vname: [] for vname in timed}
        for r in range(rounds):
            for vname, fn in timed.items():
                ms = measure_device_ms(lambda fn=fn: fn(x, w), runs=runs)
                dev[vname].append(ms)
                log("{} {} round {}: {:.4f} ms device".format(name, vname, r, ms))
        for vname, ms_list in dev.items():
            results["{}_{}_device_ms".format(name, vname)] = min(ms_list)
        results["{}_fused_speedup".format(name)] = (
            results["{}_torch_device_ms".format(name)]
            / results["{}_cuda_fused_device_ms".format(name)])
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    results = run(rounds=args.rounds, runs=args.runs, batch=args.batch, device=args.device)
    print(json.dumps(results, indent=1))
    return 0 if all(v for k, v in results.items() if k.endswith("_stats_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
