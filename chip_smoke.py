#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

Usage, from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi:

    python3 chip_smoke.py

Phases (each checks its results; any failure ends the run non-zero with no
"ok" line):

1. build: compile the hand-written CUDA kernels from ``dorknet_tpu_torch/csrc``
   with nvcc (sm_90a) and print the card's name and power limit;
2. kernel vs plain: ``depthwise3x3`` against its plain PyTorch version on the
   card at the flagship's seven depthwise shapes at batch 64, and an odd
   9x9x24, in fp32 and bf16;
3. the slice: ResNet-18-depsep at full width (225 px, 120 classes), seeded
   He-normal weights and calibrated BN statistics, served by
   ``InferenceRunner(batch_size=64, device="cuda").predict_probs`` on 150
   images (three dispatches, the last padded); every depthwise layer of every
   dispatch must launch the kernel, and the probs must match the same
   network's forward on CPU tensors;
4. serving: ``BatchingServer`` with 64 concurrent single-image requests and
   one 5-image request;
5. times (CUDA events, median of 50 after 10 warm-ups): per depthwise shape
   the kernel, the plain version and cuDNN's grouped conv; the served
   forward at batch 64 in fp32 and in bf16 flow.

The line before the last is a JSON object of the kernels of the path; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from dorknet_tpu_torch import config
from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.models import ResNet18
from dorknet_tpu_torch.network import BatchingServer, InferenceRunner
from dorknet_tpu_torch.ops.cuda.build import load_library
from dorknet_tpu_torch.ops.cuda.depthwise import depthwise3x3, depthwise3x3_plain
from dorknet_tpu_torch.utils.seeded import seed_serving_weights

DEVICE = "cuda"
BATCH = 64
IMAGE = (3, 225, 225)
NUM_CLASSES = 120
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory bandwidth

# the flagship's depthwise layers: (H = W, C, stride, how many layers)
FLAGSHIP_DW = [
    (56, 64, 1, 4), (28, 128, 1, 3), (14, 256, 1, 3), (7, 512, 1, 3),
    (56, 64, 2, 1), (28, 128, 2, 1), (14, 256, 2, 1),
]
ODD_DW = [(9, 24, 1), (9, 24, 2)]
DW_LAYERS = sum(n for *_, n in FLAGSHIP_DW)  # 16


def log(*args):
    print(*args, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise CheckFailed(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup=10, iters=50):
    """Median device time of one call of fn, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def dw_inputs(N, H, C, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(N, H, H, C, generator=g, device=DEVICE).to(dtype)
    w = torch.randn(C, 3, 3, generator=g, device=DEVICE)
    if dtype == torch.bfloat16:
        # bf16-exact weights: every product is exact in fp32, so the kernel
        # and the plain version round the same fp32 sums
        w = w.to(torch.bfloat16).float()
    return x, w


def phase_build():
    log("== phase 1: build")
    log("card:", card_line())
    kernels = load_library()
    log("build: nvcc {:.2f} s -> {}".format(kernels.build_seconds, kernels.path))
    for line in kernels.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())


def phase_kernel_vs_plain():
    """Returns the largest fp32 max-abs error at the flagship's shapes."""
    log("== phase 2: depthwise3x3 kernel vs plain on the card")
    worst = 0.0
    cases = [(H, C, s, BATCH) for H, C, s, _ in FLAGSHIP_DW] + \
            [(H, C, s, 4) for H, C, s in ODD_DW]
    for i, (H, C, stride, N) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = dw_inputs(N, H, C, dtype, seed=i)
            y = depthwise3x3(x, w, stride)
            ref = depthwise3x3_plain(x, w, stride)
            torch.cuda.synchronize()
            require(y.dtype == dtype and y.shape == ref.shape,
                    "output {} {}".format(y.dtype, tuple(y.shape)))
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if dtype == torch.float32:
                limit = 1e-5 * scale + 1e-6
                if N == BATCH:
                    worst = max(worst, err)
            else:
                limit = 1e-2
            log("  N={} {}x{}x{} s{} {}: max|err| {:.3e} (limit {:.3e}, max|y| {:.3f})"
                .format(N, H, H, C, stride, str(dtype).split(".")[1], err, limit, scale))
            require(err <= limit, "depthwise3x3 disagrees with its plain version")
    return worst


def build_nets():
    """The seeded flagship on CPU, and its copy on the card through
    load_numpy_params."""
    np.random.seed(0)
    net_cpu = ResNet18("dogs", num_classes=NUM_CLASSES)
    seed_serving_weights(net_cpu, seed=0, calib_hw=IMAGE[1:])
    net_gpu = ResNet18("dogs", num_classes=NUM_CLASSES)
    net_gpu.load_numpy_params(net_cpu.gather_params(), net_cpu.gather_states())
    return net_cpu, net_gpu.to(DEVICE)


def phase_slice(net_cpu, runner, X):
    """Returns the depthwise launches of the served run."""
    log("== phase 3: ResNet18 served by InferenceRunner on the card")
    depthwise3x3.launches = 0
    probs = runner.predict_probs(X)
    torch.cuda.synchronize()
    launches = depthwise3x3.launches
    dispatches = -(-X.shape[0] // runner.batch_size)
    log("  {} images, {} dispatches, depthwise3x3 launches {} (want {})".format(
        X.shape[0], dispatches, launches, DW_LAYERS * dispatches))
    require(launches == DW_LAYERS * dispatches, "a depthwise layer missed the kernel")
    require(probs.shape == (X.shape[0], NUM_CLASSES), "probs shape {}".format(probs.shape))
    require(np.isfinite(probs).all(), "non-finite probs")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    require(row_err <= 1e-5, "rows do not sum to 1: {}".format(row_err))

    _, want = net_cpu.forward(X[:8], test_mode=True)
    diff = float(np.abs(probs[:8] - want.numpy()).max())
    top1 = float((probs[:8].argmax(1) == want.numpy().argmax(1)).mean())
    log("  vs CPU forward on 8 images: max|dprob| {:.3e} (limit 1e-4), top-1 agreement {}"
        .format(diff, top1))
    require(diff <= 1e-4, "GPU and CPU forwards disagree")
    with torch.inference_mode():
        x8 = torch.from_numpy(X[:8]).to(DEVICE)
        logits = runner.network._run_layers(to_nhwc(x8))
    log("  logits std {:.4f}, max prob of the first 8 images {}".format(
        logits.std().item(), [round(float(p), 4) for p in probs[:8].max(1)]))
    return launches


def phase_serving(runner, X):
    log("== phase 4: BatchingServer")
    want = runner.predict_probs(X[:BATCH + 5])
    results = [None] * BATCH
    srv = BatchingServer(runner, max_wait_ms=50)
    try:
        def worker(i):
            results[i] = srv.submit(X[i]).result(timeout=300)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        require(not any(t.is_alive() for t in threads), "a request never resolved")
        multi = srv.submit(X[BATCH:BATCH + 5]).result(timeout=300)
        dispatches = srv.dispatches
    finally:
        srv.close()
    err = max(float(np.abs(np.stack(results) - want[:BATCH]).max()),
              float(np.abs(multi - want[BATCH:]).max()))
    log("  {} single-image requests + one of 5 rows: {} dispatches, max|dprob| vs runner {:.3e}"
        .format(BATCH, dispatches, err))
    require(dispatches < BATCH, "requests were not batched")
    require(err <= 1e-5, "served probs differ from the runner's")


def dw_bytes(N, H, C, stride):
    Ho = (H - 1) // stride + 1
    return (N * H * H * C + N * Ho * Ho * C) * 4


def phase_times(runner, X):
    """Returns (kernel ms, plain ms) summed over the flagship's 16 depthwise
    layers at batch 64, fp32."""
    card = card_line()
    log("== phase 5: times (CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card)
    log("  depthwise 3x3, batch {}, fp32 unless noted; cuDNN is F.conv2d(groups=C) "
        "on the channels-last view, for reference".format(BATCH))
    totals = {"kernel": 0.0, "plain": 0.0, "cudnn": 0.0, "kernel_bf16": 0.0}
    total_bytes = 0
    with torch.inference_mode():
        for i, (H, C, stride, n_layers) in enumerate(FLAGSHIP_DW):
            x, w = dw_inputs(BATCH, H, C, torch.float32, seed=100 + i)
            xb = x.to(torch.bfloat16)
            xc, wc = x.permute(0, 3, 1, 2), w.unsqueeze(1)
            t = {
                "kernel": cuda_ms(lambda: depthwise3x3(x, w, stride)),
                "plain": cuda_ms(lambda: depthwise3x3_plain(x, w, stride)),
                "cudnn": cuda_ms(lambda: F.conv2d(xc, wc, stride=stride, padding=1,
                                                  groups=C)),
                "kernel_bf16": cuda_ms(lambda: depthwise3x3(xb, w, stride)),
            }
            nbytes = dw_bytes(BATCH, H, C, stride)
            total_bytes += n_layers * nbytes
            for k in totals:
                totals[k] += n_layers * t[k]
            log("  {}x{}x{} s{} (x{} layers): kernel {:.4f} ms ({:.0f} GB/s), plain {:.4f} ms, "
                "cuDNN {:.4f} ms, kernel bf16 {:.4f} ms".format(
                    H, H, C, stride, n_layers, t["kernel"], nbytes / t["kernel"] / 1e6,
                    t["plain"], t["cudnn"], t["kernel_bf16"]))
    bound_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    log("  16 layers per batch of {}: kernel {:.4f} ms, plain {:.4f} ms, cuDNN {:.4f} ms, "
        "kernel bf16 {:.4f} ms".format(BATCH, totals["kernel"], totals["plain"],
                                       totals["cudnn"], totals["kernel_bf16"]))
    log("  fp32 bytes bound: {:.1f} MB per batch -> {:.4f} ms at 3.35 TB/s; kernel "
        "reaches {:.1%} of it".format(total_bytes / 1e6, bound_ms,
                                      bound_ms / totals["kernel"]))

    log("card:", card)
    net = runner.network
    x64 = torch.from_numpy(X[:BATCH]).to(DEVICE)
    with torch.inference_mode():
        ms32 = cuda_ms(lambda: net._test_fn(x64))
        p32 = net._test_fn(x64).float()
        config.set_compute_dtype(torch.bfloat16)
        try:
            ms16 = cuda_ms(lambda: net._test_fn(x64))
            p16 = net._test_fn(x64).float()
        finally:
            config.set_compute_dtype(torch.float32)
    dprob = (p16 - p32).abs().max().item()
    log("  served forward, batch {} (device time of _test_fn): fp32 {:.3f} ms/batch = "
        "{:.0f} img/s; bf16 flow {:.3f} ms/batch = {:.0f} img/s, max|dprob| vs fp32 {:.3e}"
        .format(BATCH, ms32, BATCH / ms32 * 1e3, ms16, BATCH / ms16 * 1e3, dprob))
    host = []
    for _ in range(12):
        t0 = time.perf_counter()
        runner.predict_probs(X[:BATCH])
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host[2:])
    log("  InferenceRunner.predict_probs, batch {} (host clock, copies included, "
        "median of 10): {:.3f} ms = {:.0f} img/s".format(BATCH, host_ms, BATCH / host_ms * 1e3))
    return totals["kernel"], totals["plain"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a "
              "CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    log("torch {} (CUDA {}), {}".format(torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))
    phase_build()
    max_err = phase_kernel_vs_plain()

    net_cpu, net_gpu = build_nets()
    runner = InferenceRunner(net_gpu, batch_size=BATCH, device=DEVICE)
    X = np.random.RandomState(1).randn(150, *IMAGE).astype(np.float32)
    launches = phase_slice(net_cpu, runner, X)
    phase_serving(runner, X)
    kernel_ms, plain_ms = phase_times(runner, X)

    log(json.dumps({"kernels": [{
        "name": "depthwise3x3",
        "route": "cuda",
        "source": "dorknet_tpu_torch/csrc/depthwise3x3.cu",
        "replaces": "dorknet_tpu/ops/pallas/depthwise.py:192",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log("card:", card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
