#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths and its kernels' A/B
once on one NVIDIA GPU and check them.

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
   forward at batch 64 in fp32 and in bf16 flow;
6. backward kernels vs plain: ``depthwise3x3_dx`` and ``depthwise3x3_dw``
   against their plain PyTorch versions at the same shapes, in fp32 and
   bf16; two dw runs must be bit-equal;
6b. ``batch_norm_stats`` against its plain PyTorch version and an fp64
   reference at the inputs of the flagship's 34 train-mode batch norms at
   batch 64 (8 distinct shapes), in fp32 and bf16, an odd 4x5x5x24, and the
   stem's 64x112x112x64 shifted by +7 (the one-pass variance's
   cancellation); two runs must be bit-equal;
6c. its times at those shapes against the plain version and
   ``torch.var_mean``;
7. the training slice: ResNet-18-depsep at full width, fresh batch norms,
   three ``Trainer.step``s (SGDMomentum, EMA) at batch 64 on seeded data;
   every step must launch the forward, dx and dw kernels 16 times each and
   ``batch_norm_stats`` 34 times, and give a finite loss. Then a CPU twin:
   two steps at batch 4 (with clip and EMA) on the card and on the CPU must
   agree;
8. training times: per depthwise shape the dx and dw kernels against their
   plain versions and cuDNN's grouped-conv backward; ``Trainer.step`` at
   batch 64 in fp32 and in bf16 flow; a ``torch.profiler`` breakdown of
   the fp32 step by kernel class;
9. augmentation kernel vs plain: ``augment_planes_fused`` against its plain
   PyTorch version on the card at the flagship's batch (60 precrops of
   281x281 uint8 -> 225x225) in six configurations (crop random or center,
   with and without HSV and rotation, crop only, no crop); no pixel more
   than 1 step off and at most 0.01% off, two runs bit-equal; times of the
   kernel and the plain version;
10. the augmented training slice: a synthetic packed directory (2,048
    images of 281x281, 120 classes) uploaded by ``DeviceResidentDataset``
    in 64 MB chunks, with the peak device memory held to the dataset plus
    one chunk; ResNet-18-depsep at full width trained by five
    ``Trainer.step_augmented_indexed`` steps (the flagship's augmentation,
    mixup, 120 images a step) and one ``multi_step_augmented_indexed`` of
    three; every step must launch the augmentation kernel once, the
    depthwise forward, dx and dw kernels 16 times each and
    ``batch_norm_stats`` 34 times, with a finite loss.
    Then, under one generator seed, ``step_augmented``,
    ``train_pipeline`` + ``Trainer.step`` and ``step_augmented_indexed``
    must agree;
10b. times of the augmented step against ``Trainer.step`` on an
    already-augmented batch of 120, and a ``torch.profiler`` split of the
    augmented step;
11. GEMM: ``matmul`` and ``matmul_bn_stats`` against their plain versions
    at the flagship's 20 pointwise GEMMs and its dense head at batch 64 in
    fp32, the BN-fusion A/B's two shapes in bf16 (y in bf16 and in fp32) and
    the JAX package's test shapes; two ``matmul_bn_stats`` runs bit-equal;
    each timed against its plain version and cuBLAS (``torch.matmul``);
12. the BN-fusion A/B (``dorknet_tpu_torch.utils.bn_fuse_ab.run``): the
    torch, fused and split variants' device ms per shape, and its 2e-2
    statistics gate;
13. ``Trainer.accumulate_step`` on a fresh flagship, K = 2 micro-batches of
    64: the BN pre-pass and the two micro-batches launch
    ``batch_norm_stats`` 34 x 3 times, the depthwise forward 48 and dx and
    dw 32 each, with a finite loss; a second call without the pre-pass, and
    its time.

The line before the last is a JSON object of the kernels of the paths; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from dorknet_tpu_torch import config
from dorknet_tpu_torch.data_loading import (DeviceResidentDataset, draw_batch_params,
                                            train_pipeline, write_packed_arrays)
from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.models import ResNet18
from dorknet_tpu_torch.network import BatchingServer, InferenceRunner, Trainer
from dorknet_tpu_torch.ops.cuda.augment import (
    _geometry, augment_param_table, augment_planes_fused, augment_planes_fused_plain,
    launch_augment_kernel)
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats, batch_norm_stats_plain
from dorknet_tpu_torch.ops.cuda.build import load_library
from dorknet_tpu_torch.ops.cuda.depthwise import (
    depthwise3x3, depthwise3x3_dw, depthwise3x3_dw_plain, depthwise3x3_dx,
    depthwise3x3_dx_plain, depthwise3x3_plain)
from dorknet_tpu_torch.ops.cuda.matmul import (matmul, matmul_bn_stats, matmul_bn_stats_plain,
                                               matmul_plain)
from dorknet_tpu_torch.optimisers import SGDMomentum
from dorknet_tpu_torch.utils import bn_fuse_ab
from dorknet_tpu_torch.utils.autotune import measure_device_ms
from dorknet_tpu_torch.utils.seeded import seed_serving_weights

DEVICE = "cuda"
BATCH = 64
IMAGE = (3, 225, 225)
NUM_CLASSES = 120
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published device-memory bandwidth
FP32_FLOPS_PER_S = 67e12   # H100 SXM published fp32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate
TRAIN_LR = 0.05 * (BATCH / 200.0)  # the flagship example's rule
KERNELS = (depthwise3x3, depthwise3x3_dx, depthwise3x3_dw)
# every training step: the three depthwise kernels and the batch-norm statistics
TRAIN_KERNELS = KERNELS + (batch_norm_stats,)

# the flagship's depthwise layers: (H = W, C, stride, how many layers)
FLAGSHIP_DW = [
    (56, 64, 1, 4), (28, 128, 1, 3), (14, 256, 1, 3), (7, 512, 1, 3),
    (56, 64, 2, 1), (28, 128, 2, 1), (14, 256, 2, 1),
]
ODD_DW = [(9, 24, 1), (9, 24, 2)]
DW_LAYERS = sum(n for *_, n in FLAGSHIP_DW)  # 16

# the flagship's train-mode batch norms: (H = W, C, how many) of their inputs
FLAGSHIP_BN = [
    (112, 64, 1), (56, 64, 9), (28, 64, 1), (28, 128, 7), (14, 128, 1), (14, 256, 7),
    (7, 256, 1), (7, 512, 7),
]
BN_LAYERS = sum(n for *_, n in FLAGSHIP_BN)  # 34
ODD_BN = (4, 5, 5, 24)
SHIFTED_BN = ((BATCH, 112, 112, 64), 7.0)  # the stem's input size, shifted by +7
TRAIN_WANT = [DW_LAYERS] * 3 + [BN_LAYERS]  # launches a training step makes

# the flagship's pointwise GEMMs: (H*W rows per image, K, N, how many): pw0,
# the 16 in the blocks and the 3 skip projections; the dense head (M, K, N)
FLAGSHIP_PW = [
    (3136, 64, 64, 5), (784, 64, 128, 2), (784, 128, 128, 3), (196, 128, 256, 2),
    (196, 256, 256, 3), (49, 256, 512, 2), (49, 512, 512, 3),
]
FLAGSHIP_DENSE = (BATCH, 512, NUM_CLASSES)
# the JAX package's GEMM test shapes (tests/test_pallas_kernels.py), (M, K, N)
JAX_TEST_GEMMS = [(64, 32, 48), (300, 512, 120), (8, 16, 128)]
# tolerances of a kernel against its plain version on the card, as multiples
# of the function's own scale: fp32 sums over up to 802,816 terms in another
# order (a few ulps each of K and M partial sums), far below any indexing fault
GEMM_RTOL = 2e-5  # of (|a| @ |b|) per element of y
STATS_RTOL = 2e-5  # of sqrt(E[x^2]) for a mean, of E[x^2] for a variance
ACC_K = 2  # micro-batches of the accumulate step

# the flagship example's on-device augmentation: batch 60 (120 trained
# images a step with mixup), 225 px cut from a 281 px precrop
AUG_BATCH = 60
PRECROP = 281
AUG_OUT = (225, 225)
AUG_CFG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)),
               rotation_tuple=(-15.0, 15.0), horizontal_flip_prob=0.5, crop_mode="random")
AUG_CONFIGS = [("all", AUG_CFG), ("center", dict(AUG_CFG, crop_mode="center")),
               ("no_rotation", dict(AUG_CFG, rotation_tuple=None)),
               ("no_hsv", dict(AUG_CFG, hsv_pert_tuples=None)),
               ("crop_only", dict(hsv_pert_tuples=None, rotation_tuple=None,
                                  horizontal_flip_prob=None, crop_mode="random")),
               ("no_crop", dict(AUG_CFG, crop_mode=None))]
MIXUP = (0.0, 0.3)
AUG_LR = 0.05 * (2 * AUG_BATCH / 200.0)  # the example's rule at 2B trained images
DATASET_IMAGES = 2048
CHUNK_BYTES = 64 << 20
# fp32 operations of the arithmetic in csrc/augment_planes.cu: a pixel's HSV
# round trip, one lerp of a shear, and one line's shift
AUG_HSV_OPS, AUG_LERP_OPS, AUG_SHIFT_OPS = 39, 7, 6


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
    return measure_device_ms(fn, runs=iters, warmup=warmup)


def profiled_ms(calls, repeats=5):
    """Device ms of one pass over ``calls`` (thunks): the time of every
    kernel they launch, from torch.profiler, summed, with the host's gaps
    between launches left out; the mean of ``repeats`` passes after one
    warm-up pass."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / repeats


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
    depthwise3x3.launches = batch_norm_stats.launches = 0
    probs = runner.predict_probs(X)
    torch.cuda.synchronize()
    launches = depthwise3x3.launches
    dispatches = -(-X.shape[0] // runner.batch_size)
    log("  {} images, {} dispatches, depthwise3x3 launches {} (want {}), batch_norm_stats "
        "launches {} (want 0: test mode)".format(X.shape[0], dispatches, launches,
                                                 DW_LAYERS * dispatches,
                                                 batch_norm_stats.launches))
    require(launches == DW_LAYERS * dispatches, "a depthwise layer missed the kernel")
    require(batch_norm_stats.launches == 0, "a test-mode batch norm took batch statistics")
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
        logits, _, _ = runner.network._run_layers(to_nhwc(x8))
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


def dw_bound_ms(N, H, C, stride, extra_bytes=0):
    """The least time of one depthwise 3x3 pass (forward, dx or dw) at batch
    N in fp32: the larger of its bytes (the activation read and the one
    written, or for dw the two read, each once) over the memory rate, and
    its 18 flops per output element over the fp32 rate. Returns (ms, what
    bounds it)."""
    Ho = (H - 1) // stride + 1
    t_bytes = (dw_bytes(N, H, C, stride) + extra_bytes) / HBM_BYTES_PER_S
    t_ops = 18.0 * N * Ho * Ho * C / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flagship_bound_ms(extra_bytes_per_layer=lambda C: 0):
    """(ms, what bounds it) summed over the flagship's 16 depthwise layers."""
    total, by = 0.0, set()
    for H, C, stride, n_layers in FLAGSHIP_DW:
        ms, what = dw_bound_ms(BATCH, H, C, stride, extra_bytes_per_layer(C))
        total += n_layers * ms
        by.add(what)
    return total, "bytes" if by == {"bytes"} else "operations"


def phase_times(runner, X):
    """Returns the kernel, plain and cuDNN ms summed over the flagship's 16
    depthwise layers at batch 64, fp32."""
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
    return totals


def grad_input(N, H, C, stride, dtype, seed):
    """A seeded upstream gradient g for a depthwise layer's output."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    Ho = (H - 1) // stride + 1
    return torch.randn(N, Ho, Ho, C, generator=g, device=DEVICE).to(dtype)


def phase_bwd_vs_plain():
    """Returns the largest fp32 max-abs errors of dx and dw at the
    flagship's shapes."""
    log("== phase 6: depthwise3x3_dx and depthwise3x3_dw kernels vs plain on the card")
    log("  limits: dx as the forward (fp32 1e-5*max|dx|+1e-6; bf16 1e-2, equal sums "
        "expected); dw 2e-5*sum|x*g| per tap and channel + 1e-6; dw twice bit-equal")
    worst = {"dx": 0.0, "dw": 0.0}
    cases = [(H, C, s, BATCH) for H, C, s, _ in FLAGSHIP_DW] + \
            [(H, C, s, 4) for H, C, s in ODD_DW]
    for i, (H, C, stride, N) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = dw_inputs(N, H, C, dtype, seed=200 + i)
            g = grad_input(N, H, C, stride, dtype, seed=300 + i)
            dx = depthwise3x3_dx(g, w, stride, H, H)
            ref = depthwise3x3_dx_plain(g, w, stride, H, H)
            dw = depthwise3x3_dw(x, g, stride)
            dw2 = depthwise3x3_dw(x, g, stride)
            dw_ref = depthwise3x3_dw_plain(x, g, stride)
            scale = depthwise3x3_dw_plain(x.float().abs(), g.float().abs(), stride)
            torch.cuda.synchronize()
            require(dx.dtype == dtype and dx.shape == x.shape,
                    "dx {} {}".format(dx.dtype, tuple(dx.shape)))
            require(dw.dtype == torch.float32 and dw.shape == (C, 3, 3),
                    "dw {} {}".format(dw.dtype, tuple(dw.shape)))
            dx_err = (dx.float() - ref.float()).abs().max().item()
            dx_scale = ref.float().abs().max().item()
            dx_limit = 1e-5 * dx_scale + 1e-6 if dtype == torch.float32 else 1e-2
            dw_diff = (dw - dw_ref).abs()
            dw_err = dw_diff.max().item()
            dw_ratio = (dw_diff / (2e-5 * scale + 1e-6)).max().item()
            same = bool(torch.equal(dw, dw2))
            if dtype == torch.float32 and N == BATCH:
                worst["dx"] = max(worst["dx"], dx_err)
                worst["dw"] = max(worst["dw"], dw_err)
            log("  N={} {}x{}x{} s{} {}: dx max|err| {:.3e} (limit {:.3e}); dw max|err| "
                "{:.3e}, {:.3f} of its limit, repeat bit-equal {}".format(
                    N, H, H, C, stride, str(dtype).split(".")[1], dx_err, dx_limit,
                    dw_err, dw_ratio, same))
            require(dx_err <= dx_limit, "depthwise3x3_dx disagrees with its plain version")
            require(dw_ratio <= 1.0, "depthwise3x3_dw disagrees with its plain version")
            require(same, "two depthwise3x3_dw runs differ")
    return worst


def bn_input(shape, dtype, seed, shift=0.0):
    """A seeded activation-like input: 1.5 * normal + 0.25 + shift."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=DEVICE) * 1.5 + (0.25 + shift)).to(dtype)


def stats_errors(mean, var, ref_mean, ref_var, second_moment):
    """(max |dmean|, max |dvar|, the worst share of the limit) of batch-norm
    statistics against a reference. The limits, per channel: STATS_RTOL of
    sqrt(E[x^2]) for the mean and of E[x^2] for the variance, the scales of
    the fp32 sums' rounding (the one-pass variance inherits that of E[x^2])."""
    dm = (mean.double() - ref_mean.double()).abs()
    dv = (var.double() - ref_var.double()).abs()
    e2 = second_moment.double()
    ratio = torch.maximum(dm / (STATS_RTOL * e2.sqrt() + 1e-12),
                          dv / (STATS_RTOL * e2 + 1e-12)).max().item()
    return dm.max().item(), dv.max().item(), ratio


def phase_bn_stats_vs_plain():
    """Returns the largest fp32 max-abs error of the mean and variance at
    the flagship's shapes."""
    log("== phase 6b: batch_norm_stats kernel vs plain on the card")
    log("  limits per channel: mean within {0:g} x sqrt(E[x^2]), var within {0:g} x E[x^2], "
        "against the plain version and an fp64 reference; two runs bit-equal".format(
            STATS_RTOL))
    worst = 0.0
    cases = [((BATCH, H, H, C), 0.0) for H, C, _ in FLAGSHIP_BN] + [(ODD_BN, 0.0), SHIFTED_BN]
    for i, (shape, shift) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16) if not shift else (torch.float32,):
            x = bn_input(shape, dtype, seed=600 + i, shift=shift)
            mean, var = batch_norm_stats(x)
            mean2, var2 = batch_norm_stats(x)
            plain_mean, plain_var = batch_norm_stats_plain(x)
            dims = tuple(range(x.dim() - 1))
            x64 = x.double()
            mean64 = x64.mean(dim=dims)
            var64 = ((x64 - mean64) ** 2).mean(dim=dims)
            del x64
            e2 = var64 + mean64 * mean64
            torch.cuda.synchronize()
            same = torch.equal(mean, mean2) and torch.equal(var, var2)
            dm, dv, ratio = stats_errors(mean, var, plain_mean, plain_var, e2)
            dm64, dv64, ratio64 = stats_errors(mean, var, mean64, var64, e2)
            _, _, plain_ratio64 = stats_errors(plain_mean, plain_var, mean64, var64, e2)
            if dtype == torch.float32 and shape[0] == BATCH and not shift:
                worst = max(worst, dm, dv)
            log("  {}{} {}: vs plain max|dmean| {:.3e} max|dvar| {:.3e} ({:.3f} of the limit); "
                "vs fp64 {:.3e} {:.3e} ({:.3f}; plain {:.3f}); repeat bit-equal {}".format(
                    shape, " +{:g}".format(shift) if shift else "", str(dtype).split(".")[1],
                    dm, dv, ratio, dm64, dv64, ratio64, plain_ratio64, same))
            require(ratio <= 1.0 and ratio64 <= 1.0,
                    "batch_norm_stats disagrees with its plain version or the fp64 reference")
            require(same, "two batch_norm_stats runs differ")
    return worst


def phase_bn_stats_times():
    """Returns the kernel's, the plain version's and torch.var_mean's ms
    summed over the flagship's 34 batch norms at batch 64 in fp32, with the
    bound of that work and what sets it."""
    log("== phase 6c: batch_norm_stats times (CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card_line())
    log("  batch {}, fp32 unless noted; torch.var_mean(correction=0) for reference".format(
        BATCH))
    totals = dict.fromkeys(("kernel", "plain", "var_mean", "kernel_bf16"), 0.0)
    fns = {
        "kernel": batch_norm_stats,
        "plain": batch_norm_stats_plain,
        "var_mean": lambda x: torch.var_mean(x, dim=(0, 1, 2), correction=0),
    }
    calls = {k: [] for k in fns}  # the 34 calls of a step, for the profiler
    n_elems = 0
    for i, (H, C, n) in enumerate(FLAGSHIP_BN):
        x = bn_input((BATCH, H, H, C), torch.float32, seed=700 + i)
        xb = x.to(torch.bfloat16)
        t = {k: cuda_ms(lambda fn=fn: fn(x)) for k, fn in fns.items()}
        t["kernel_bf16"] = cuda_ms(lambda: batch_norm_stats(xb))
        for k in totals:
            totals[k] += n * t[k]
        for k, fn in fns.items():
            calls[k] += [lambda fn=fn, x=x: fn(x)] * n
        n_elems += n * x.numel()
        log("  {}x{}x{} (x{}): kernel {:.4f} ms ({:.0f} GB/s), plain {:.4f}, var_mean {:.4f}, "
            "kernel bf16 {:.4f}".format(H, H, C, n, t["kernel"], x.numel() * 4 / t["kernel"] / 1e6,
                                        t["plain"], t["var_mean"], t["kernel_bf16"]))
    # one read of x, and a sum, a multiply and an add per element
    t_bytes = n_elems * 4 / HBM_BYTES_PER_S
    t_ops = 3.0 * n_elems / FP32_FLOPS_PER_S
    bound, by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    log("  {} batch norms per batch of {}: kernel {:.4f} ms, plain {:.4f} ms, var_mean {:.4f} "
        "ms, kernel bf16 {:.4f} ms; bound {:.4f} ms ({}; {:.1f} MB at 3.35 TB/s), the kernel "
        "reaches {:.1%} of it".format(BN_LAYERS, BATCH, totals["kernel"], totals["plain"],
                                      totals["var_mean"], totals["kernel_bf16"], bound, by,
                                      n_elems * 4 / 1e6, bound / totals["kernel"]))
    device = {k: profiled_ms(c) for k, c in calls.items()}
    log("  the same 34 calls, device time of their kernels (torch.profiler, host gaps left "
        "out, mean of 5): kernel {:.4f} ms ({:.1%} of the bound), plain {:.4f} ms, var_mean "
        "{:.4f} ms".format(device["kernel"], bound / device["kernel"], device["plain"],
                           device["var_mean"]))
    return dict(ms=totals["kernel"], plain_ms=totals["plain"], library_ms=totals["var_mean"],
                bound_ms=bound, bound_by=by)


def train_batches(seed, steps, B):
    rng = np.random.RandomState(seed)
    X = rng.randn(steps, B, *IMAGE).astype(np.float32)
    y = np.eye(NUM_CLASSES, dtype=np.float32)[rng.randint(0, NUM_CLASSES, (steps, B))]
    return X, y


def fresh_resnet18():
    np.random.seed(0)
    return ResNet18("dogs", num_classes=NUM_CLASSES)


def phase_train():
    """Returns the trainer and the launches of each kernel over its three
    steps."""
    log("== phase 7: ResNet18 trained by Trainer.step on the card")
    net = fresh_resnet18()
    trainer = Trainer(net, SGDMomentum(net, TRAIN_LR, 0.9), ema_decay=0.999, device=DEVICE)
    X, y = train_batches(2, 3, BATCH)
    for k in TRAIN_KERNELS:
        k.launches = 0
    for step in range(3):
        before = [k.launches for k in TRAIN_KERNELS]
        loss, preds = trainer.step(X[step], y[step])
        torch.cuda.synchronize()
        per_step = [k.launches - b for k, b in zip(TRAIN_KERNELS, before)]
        log("  step {}: loss {:.6f}, launches forward/dx/dw/bn_stats {}".format(
            step, float(loss), per_step))
        require(per_step == TRAIN_WANT, "a depthwise layer or a batch norm missed a kernel")
        require(np.isfinite(float(loss)), "non-finite loss")
        require(tuple(preds.shape) == (BATCH,), "preds shape {}".format(tuple(preds.shape)))
    launches = [k.launches for k in TRAIN_KERNELS]
    require(all(l.bn_initialized() for l in net.layers), "a batch norm was not initialised")
    require(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
            "non-finite parameters")
    require(all(bool(torch.isfinite(e).all()) for e in trainer._ema), "non-finite EMA")
    log("  3 steps at batch {}: launches forward/dx/dw/bn_stats {} (want {})".format(
        BATCH, launches, [3 * n for n in TRAIN_WANT]))
    return trainer, launches


def phase_train_twin():
    """Two steps at batch 4 on the card and on the CPU from the same fresh
    weights, with clip and EMA; returns nothing, raises on a mismatch."""
    log("== phase 7b: the same training on the CPU (batch 4, clip 1.0, EMA 0.9)")
    X, y = train_batches(3, 2, 4)
    trainers = []
    for device in (DEVICE, "cpu"):
        net = fresh_resnet18()
        trainers.append(Trainer(net, SGDMomentum(net, 0.05 * 4 / 200.0, 0.9),
                                ema_decay=0.9, clip_norm=1.0, device=device))
    for step in range(2):
        got, want = (float(t.step(X[step], y[step])[0]) for t in trainers)
        rel = abs(got - want) / abs(want)
        log("  step {}: loss card {:.7f}, CPU {:.7f}, relative difference {:.3e} "
            "(limit 1e-4)".format(step, got, want, rel))
        require(rel <= 1e-4, "card and CPU losses disagree")
    pairs = [(a, b) for a, b in zip(trainers[0].network.parameters(),
                                    trainers[1].network.parameters(), strict=True)]
    pairs += list(zip(trainers[0]._ema, trainers[1]._ema, strict=True))
    worst_abs = max((a.detach().cpu() - b.detach()).abs().max().item() for a, b in pairs)
    worst = max(((a.detach().cpu() - b.detach()).abs() / (1e-5 + 1e-4 * b.detach().abs()))
                .max().item() for a, b in pairs)
    log("  parameters and EMA after 2 steps: max|diff| {:.3e}, {:.3f} of the limit "
        "(1e-4 relative + 1e-5 absolute)".format(worst_abs, worst))
    require(worst <= 1.0, "card and CPU parameters disagree")


def cudnn_grad(g, x, w, stride, mask):
    """cuDNN's grouped-conv backward, the function autograd of
    F.conv2d(groups=C) calls, on the channels-last views (a yardstick only)."""
    return torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.unsqueeze(1), None,
        [stride, stride], [1, 1], [1, 1], False, [0, 0], x.shape[3], mask)


def phase_bwd_times():
    """Returns {name: ms} summed over the flagship's 16 depthwise layers,
    fp32, batch 64."""
    log("== phase 8: backward kernel times (CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card_line())
    log("  depthwise 3x3 backward, batch {}, fp32 unless noted; cuDNN is "
        "aten.convolution_backward of F.conv2d(groups=C) on the channels-last "
        "views, for reference".format(BATCH))
    keys = ("dx", "dx_plain", "dx_cudnn", "dx_bf16", "dw", "dw_plain", "dw_cudnn", "dw_bf16")
    totals = dict.fromkeys(keys, 0.0)
    for i, (H, C, stride, n_layers) in enumerate(FLAGSHIP_DW):
        x, w = dw_inputs(BATCH, H, C, torch.float32, seed=400 + i)
        g = grad_input(BATCH, H, C, stride, torch.float32, seed=500 + i)
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        t = {
            "dx": cuda_ms(lambda: depthwise3x3_dx(g, w, stride, H, H)),
            "dx_plain": cuda_ms(lambda: depthwise3x3_dx_plain(g, w, stride, H, H)),
            "dx_cudnn": cuda_ms(lambda: cudnn_grad(g, x, w, stride, [True, False, False])),
            "dx_bf16": cuda_ms(lambda: depthwise3x3_dx(gb, w, stride, H, H)),
            "dw": cuda_ms(lambda: depthwise3x3_dw(x, g, stride)),
            "dw_plain": cuda_ms(lambda: depthwise3x3_dw_plain(x, g, stride)),
            "dw_cudnn": cuda_ms(lambda: cudnn_grad(g, x, w, stride, [False, True, False])),
            "dw_bf16": cuda_ms(lambda: depthwise3x3_dw(xb, gb, stride)),
        }
        for k in keys:
            totals[k] += n_layers * t[k]
        nbytes = dw_bytes(BATCH, H, C, stride)
        log("  {}x{}x{} s{} (x{}): dx {:.4f} ms ({:.0f} GB/s), plain {:.4f}, cuDNN {:.4f}, "
            "bf16 {:.4f} | dw {:.4f} ms ({:.0f} GB/s), plain {:.4f}, cuDNN {:.4f}, "
            "bf16 {:.4f}".format(
                H, H, C, stride, n_layers, t["dx"], nbytes / t["dx"] / 1e6, t["dx_plain"],
                t["dx_cudnn"], t["dx_bf16"], t["dw"], nbytes / t["dw"] / 1e6,
                t["dw_plain"], t["dw_cudnn"], t["dw_bf16"]))
    bound, _ = flagship_bound_ms()
    for k in ("dx", "dw"):
        log("  16 layers per batch of {}: {} kernel {:.4f} ms, plain {:.4f} ms, cuDNN {:.4f} "
            "ms, kernel bf16 {:.4f} ms; fp32 bound {:.4f} ms, the kernel reaches {:.1%} of "
            "it".format(BATCH, k, totals[k], totals[k + "_plain"], totals[k + "_cudnn"],
                        totals[k + "_bf16"], bound, bound / totals[k]))
    return totals


def kernel_class(name):
    n = name.lower()
    if "augment_rotate" in n or "augment_pointwise" in n:
        return "augmentation kernel"
    if "gather" in n or "indexselect" in n:
        return "gathers (dataset rows, mixup partners)"
    if "depthwise3x3_dx" in n:
        return "depthwise dx"
    if "depthwise3x3_dw" in n:
        return "depthwise dw"
    if "depthwise3x3_fwd" in n:
        return "depthwise forward"
    if "bn_stats_partial" in n or "stats_finish" in n:
        return "batch-norm statistics kernel"
    if "matmul_kernel" in n:
        return "hand-written GEMM"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "cublas" in n:
        return "GEMM"
    if "conv" in n or "cudnn" in n or "dgrad" in n or "wgrad" in n:
        return "cuDNN conv"
    if "multi_tensor_apply" in n:
        return "optimiser, clip and EMA (_foreach)"
    return "elementwise and reductions"


def phase_train_times(trainer):
    """Trainer.step at batch 64 in fp32 and bf16 flow; returns the fp32 ms."""
    log("== phase 8b: Trainer.step times (CUDA events around the step, median of 10 "
        "after 3 warm-ups; batch already on the card)")
    log("card:", card_line())
    X, y = train_batches(4, 1, BATCH)
    x = torch.from_numpy(X[0]).to(DEVICE)
    yt = torch.from_numpy(y[0]).to(DEVICE)
    ms32 = cuda_ms(lambda: trainer.step(x, yt), warmup=3, iters=10)
    config.set_compute_dtype(torch.bfloat16)
    try:
        ms16 = cuda_ms(lambda: trainer.step(x, yt), warmup=3, iters=10)
        loss16 = float(trainer.step(x, yt)[0])
    finally:
        config.set_compute_dtype(torch.float32)
    require(np.isfinite(loss16), "non-finite bf16-flow loss")
    log("  Trainer.step, batch {}: fp32 {:.3f} ms = {:.0f} img/s; bf16 flow {:.3f} ms = "
        "{:.0f} img/s (loss {:.4f})".format(BATCH, ms32, BATCH / ms32 * 1e3, ms16,
                                            BATCH / ms16 * 1e3, loss16))

    steps = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(x, yt)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device time
        # is the same kernels' time again
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.device_time_total
        n_kernels += evt.count
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / steps
        by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3 / steps
    busy = sum(by_class.values())
    per_step = span_ms / steps
    if busy == 0.0:
        log("  profiler: no device time recorded")
        return ms32
    log("  profiler, fp32 step (host clock with the profiler on: {:.3f} ms a step): {} "
        "kernels a step, busy {:.3f} ms, idle share {:.1%}".format(
            per_step, n_kernels // steps, busy, max(0.0, 1.0 - busy / per_step)))
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log("    {:<30} {:8.3f} ms  {:5.1%}".format(cls, ms, ms / busy))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log("    top: {:8.3f} ms  {}".format(ms, name[:110]))
    return ms32


def precrop_batch(B, H, W, seed):
    """uint8 (B,H,W,3) BGR on the card: a smooth pattern per channel plus
    noise, so the HSV sectors and the shear lerps all matter."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    yy = torch.arange(H, device=DEVICE).view(1, H, 1, 1).float()
    xx = torch.arange(W, device=DEVICE).view(1, 1, W, 1).float()
    base = 127 + 60 * torch.sin(yy / 9.0 + torch.arange(3, device=DEVICE)) + \
        50 * torch.cos(xx / 13.0)
    noise = torch.randint(-40, 41, (B, H, W, 3), generator=g, device=DEVICE)
    return torch.clamp(base + noise, 0, 255).to(torch.uint8)


def augment_bound_ms(B, H, W, oh, ow, P, cropped):
    """(ms, what bounds it, bytes) of the function one augmentation call
    computes. Bytes: each pixel it reads once (only the oh x ow window when
    it crops, the whole H x W input without a crop) and each output pixel
    written once, over the memory rate. Operations: the function's fp32
    arithmetic over the fp32 rate, HSV once a pixel (the kernel recomputes
    it in each channel's block, the function needs it once), the shear lerps
    of every channel, and the line shifts once an image (shared by its
    channels)."""
    n_bytes = B * 3 * ((oh * ow if cropped else H * W) + oh * ow)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    ops = AUG_HSV_OPS * B * oh * ow
    if P:
        Wp = ow + 2 * P
        ops += AUG_LERP_OPS * B * 3 * (2 * oh * Wp + oh * ow) + AUG_SHIFT_OPS * B * (oh + Wp)
    t_ops = ops / FP32_FLOPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, n_bytes


def phase_augment_vs_plain():
    """Returns the flagship configuration's numbers: max |err| in uint8
    steps, pixels off, kernel ms, plain ms, bound ms, what bounds it."""
    log("== phase 9: augment_planes_fused kernel vs plain on the card")
    log("  batch {} of {}x{} uint8 -> {}; limits: no pixel more than 1 step off, at most "
        "0.01% off; two runs bit-equal".format(AUG_BATCH, PRECROP, PRECROP, AUG_OUT))
    x = precrop_batch(AUG_BATCH, PRECROP, PRECROP, seed=9)
    result = None
    for i, (name, cfg) in enumerate(AUG_CONFIGS):
        params = draw_batch_params(torch.Generator(device=DEVICE).manual_seed(90 + i),
                                   AUG_BATCH, (PRECROP, PRECROP), AUG_OUT, **cfg)
        oh, ow, P = _geometry(x, AUG_OUT, cfg["rotation_tuple"], cfg["crop_mode"])
        table = augment_param_table(params, AUG_BATCH, (PRECROP, PRECROP), (oh, ow),
                                    device=DEVICE, **cfg)
        hsv_on = cfg["hsv_pert_tuples"] is not None
        flip_on = cfg["horizontal_flip_prob"] is not None
        got = augment_planes_fused(x, params, AUG_OUT, **cfg)
        again = launch_augment_kernel(x, table, (oh, ow), hsv_on, P)
        want = augment_planes_fused_plain(x, table, (oh, ow), hsv_on, P, flip_on)
        torch.cuda.synchronize()
        require(got.dtype == torch.uint8 and got.shape == want.shape,
                "output {} {}".format(got.dtype, tuple(got.shape)))
        diff = (got.int() - want.int()).abs()
        err, off = diff.max().item(), int((diff > 0).sum().item())
        same = bool(torch.equal(got, again))
        log("  {:<12} -> {}x{}: max|err| {} steps, {} of {} pixels off ({:.5%}), repeat "
            "bit-equal {}".format(name, oh, ow, err, off, diff.numel(), off / diff.numel(),
                                  same))
        require(err <= 1 and off <= 1e-4 * diff.numel(),
                "augment_planes_fused disagrees with its plain version")
        require(same, "two augment_planes_fused runs differ")
        if name == "all":
            ms = cuda_ms(lambda: launch_augment_kernel(x, table, (oh, ow), hsv_on, P))
            plain_ms = cuda_ms(lambda: augment_planes_fused_plain(x, table, (oh, ow), hsv_on,
                                                                  P, flip_on))
            bound, by, n_bytes = augment_bound_ms(AUG_BATCH, PRECROP, PRECROP, oh, ow, P,
                                                  cfg["crop_mode"] is not None)
            result = dict(max_abs_err=err, pixels_off=off, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by)
            log("  times (CUDA events, median of 50 after 10 warm-ups), card: {}".format(
                card_line()))
            log("  flagship configuration: kernel {:.4f} ms, plain {:.4f} ms; bound {:.4f} ms "
                "({}; {:.1f} MB at 3.35 TB/s), the kernel reaches {:.1%} of it".format(
                    ms, plain_ms, bound, by, n_bytes / 1e6, bound / ms))
    return result


def dataset_rows(labels):
    """Rows start:stop of the synthetic dataset: a smooth pattern shifted
    per image, brightened in channel (label mod 3), plus noise."""
    yy, xx = np.mgrid[0:PRECROP, 0:PRECROP]
    base = np.stack([127 + 60 * np.sin(yy / 9.0 + c) + 50 * np.cos(xx / 13.0)
                     for c in range(3)], axis=-1).astype(np.float32)

    def rows(start, stop):
        rng = np.random.default_rng(start)
        out = np.empty((stop - start, PRECROP, PRECROP, 3), np.uint8)
        for i in range(start, stop):
            im = np.roll(base, (i * 7) % PRECROP, axis=1)
            im[..., labels[i] % 3] += 40
            im += rng.integers(-30, 31, im.shape, dtype=np.int16)
            out[i - start] = np.clip(im, 0, 255)
        return out

    return rows


def write_dataset(path):
    labels = np.arange(DATASET_IMAGES) * NUM_CLASSES // DATASET_IMAGES
    t0 = time.perf_counter()
    write_packed_arrays(path, dataset_rows(labels), labels,
                        ["class{:03d}".format(c) for c in range(NUM_CLASSES)])
    log("  wrote {} images of {}x{}x3 ({:.1f} MB) in {:.2f} s".format(
        DATASET_IMAGES, PRECROP, PRECROP, DATASET_IMAGES * PRECROP * PRECROP * 3 / 1e6,
        time.perf_counter() - t0))


def upload_dataset(path):
    """DeviceResidentDataset with its peak device memory checked."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dd = DeviceResidentDataset(path, AUG_BATCH, class_balance=False,
                               expect_precrop=(PRECROP, PRECROP), chunk_bytes=CHUNK_BYTES,
                               device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    nbytes = dd.images.numel()
    limit = nbytes + CHUNK_BYTES + (8 << 20)
    log("  upload: {:.2f} s; device memory peak {:.1f} MB over the dataset's {:.1f} MB "
        "(limit: dataset + one {} MB chunk + 8 MB = {:.1f} MB)".format(
            seconds, peak / 1e6, nbytes / 1e6, CHUNK_BYTES >> 20, limit / 1e6))
    require(peak <= limit, "the upload held more than the dataset and one chunk")
    probe = np.array([0, DATASET_IMAGES // 2, DATASET_IMAGES - 1])
    require(np.array_equal(dd.images[torch.from_numpy(probe).to(DEVICE)].cpu().numpy(),
                           dd.packed.gather(probe)), "uploaded rows differ from the pack")
    return dd


def fresh_aug_trainer(**kwargs):
    net = fresh_resnet18()
    return Trainer(net, SGDMomentum(net, AUG_LR, 0.9), ema_decay=0.999, device=DEVICE,
                   **kwargs)


AUG_KERNELS = (augment_planes_fused,) + TRAIN_KERNELS


def phase_aug_train(dd):
    """Returns the trainer, the launches of the five kernels over its eight
    steps, and the rows of its last step."""
    log("== phase 10: ResNet18 trained by Trainer.step_augmented_indexed on the card")
    trainer = fresh_aug_trainer()
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    aug = dict(AUG_CFG, mixup=MIXUP)
    want = [1] + TRAIN_WANT
    for k in AUG_KERNELS:
        k.launches = 0
    for step in range(5):
        before = [k.launches for k in AUG_KERNELS]
        rows = dd.next_indices()
        loss, preds = trainer.step_augmented_indexed(gen, dd.images, dd.labels, rows, AUG_OUT,
                                                     dd.num_classes, **aug)
        torch.cuda.synchronize()
        per_step = [k.launches - b for k, b in zip(AUG_KERNELS, before)]
        log("  step {}: loss {:.6f}, launches augment/forward/dx/dw/bn_stats {}".format(
            step, float(loss), per_step))
        require(per_step == want, "a step missed a kernel")
        require(np.isfinite(float(loss)), "non-finite loss")
        require(tuple(preds.shape) == (2 * AUG_BATCH,), "preds {}".format(tuple(preds.shape)))
    before = [k.launches for k in AUG_KERNELS]
    rows_stack = np.stack([dd.next_indices() for _ in range(3)])
    losses, preds = trainer.multi_step_augmented_indexed(
        gen, dd.images, dd.labels, rows_stack, AUG_OUT, dd.num_classes, **aug)
    torch.cuda.synchronize()
    per_call = [k.launches - b for k, b in zip(AUG_KERNELS, before)]
    log("  multi_step_augmented_indexed K=3: losses {}, launches "
        "augment/forward/dx/dw/bn_stats {}"
        .format([round(float(v), 6) for v in losses], per_call))
    require(per_call == [3 * n for n in want], "a step of the K=3 call missed a kernel")
    require(bool(torch.isfinite(losses).all()) and tuple(preds.shape) == (3, 2 * AUG_BATCH),
            "multi-step losses or preds")
    launches = [k.launches for k in AUG_KERNELS]
    require(all(bool(torch.isfinite(p).all()) for p in trainer.network.parameters()),
            "non-finite parameters")
    log("  8 steps of {} trained images: launches augment/forward/dx/dw/bn_stats {}".format(
        2 * AUG_BATCH, launches))
    return trainer, launches, rows_stack[-1]


def phase_aug_equal(dd, rows):
    """step_augmented, train_pipeline + Trainer.step and
    step_augmented_indexed from one generator seed and fresh weights."""
    log("== phase 10 (cont.): one seed, three entry points")
    aug = dict(AUG_CFG, mixup=MIXUP)
    X = dd.images.index_select(0, torch.from_numpy(rows).long().to(DEVICE))
    y = F.one_hot(dd.labels[torch.from_numpy(rows).long().to(DEVICE)].long(),
                  dd.num_classes).float()
    results = []
    for how in ("step_augmented", "train_pipeline + step", "step_augmented_indexed"):
        trainer = fresh_aug_trainer(input_layout="NHWC" if how == "train_pipeline + step"
                                    else "NCHW")
        gen = torch.Generator(device=DEVICE).manual_seed(77)
        if how == "step_augmented":
            loss, _ = trainer.step_augmented(gen, X, y, AUG_OUT, **aug)
        elif how == "step_augmented_indexed":
            loss, _ = trainer.step_augmented_indexed(gen, dd.images, dd.labels, rows, AUG_OUT,
                                                     dd.num_classes, **aug)
        else:
            x, yy = train_pipeline(gen, X, y, AUG_OUT, output_layout="NHWC", **aug)
            loss, _ = trainer.step(x, yy)
        results.append((how, float(loss), [p.detach().clone() for p in
                                           trainer.network.parameters()]))
    _, loss0, params0 = results[0]
    for how, loss, params in results[1:]:
        worst = max((a - b).abs().max().item() for a, b in zip(params, params0, strict=True))
        rel = abs(loss - loss0) / abs(loss0)
        log("  {} vs step_augmented: loss {:.7f} vs {:.7f} (relative {:.2e}), parameters "
            "max|diff| {:.3e}".format(how, loss, loss0, rel, worst))
        require(rel <= 1e-6 and worst <= 1e-6, "{} disagrees with step_augmented".format(how))


def phase_aug_times(trainer, dd, rows):
    """Returns the augmented step's ms."""
    log("== phase 10b: augmented step times (CUDA events around the step; the mean of two "
        "turns, each the median of 10 after 3 warm-ups)")
    log("card:", card_line())
    aug = dict(AUG_CFG, mixup=MIXUP)
    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def aug_step():
        return trainer.step_augmented_indexed(gen, dd.images, dd.labels, rows, AUG_OUT,
                                              dd.num_classes, **aug)

    X = dd.images.index_select(0, torch.from_numpy(rows).long().to(DEVICE))
    y = F.one_hot(dd.labels[torch.from_numpy(rows).long().to(DEVICE)].long(),
                  dd.num_classes).float()
    x, yy = train_pipeline(gen, X, y, AUG_OUT, output_layout="NHWC", **aug)
    nhwc = Trainer(trainer.network, SGDMomentum(trainer.network, AUG_LR, 0.9),
                   input_layout="NHWC", device=DEVICE)
    # in turns (augmented, plain, plain, augmented): the host's pace drifts
    times = {"aug": [], "plain": []}
    for which in ("aug", "plain", "plain", "aug"):
        fn = aug_step if which == "aug" else (lambda: nhwc.step(x, yy))
        times[which].append(cuda_ms(fn, warmup=3, iters=10))
    ms_aug, ms_plain = (statistics.mean(times[k]) for k in ("aug", "plain"))
    n = 2 * AUG_BATCH
    log("  step_augmented_indexed, {} trained images: {:.3f} ms = {:.0f} img/s (turns {}); "
        "Trainer.step on the augmented batch: {:.3f} ms = {:.0f} img/s (turns {}); the input "
        "path adds {:.3f} ms".format(
            n, ms_aug, n / ms_aug * 1e3, [round(t, 3) for t in times["aug"]], ms_plain,
            n / ms_plain * 1e3, [round(t, 3) for t in times["plain"]], ms_aug - ms_plain))

    steps = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            aug_step()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += evt.count
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + evt.device_time_total / 1e3 / steps
        by_name[evt.key] = by_name.get(evt.key, 0.0) + evt.device_time_total / 1e3 / steps
    busy = sum(by_class.values())
    per_step = span_ms / steps
    if busy == 0.0:
        log("  profiler: no device time recorded")
        return ms_aug
    log("  profiler, augmented step (host clock with the profiler on: {:.3f} ms a step): {} "
        "kernels a step, busy {:.3f} ms, idle share {:.1%}".format(
            per_step, n_kernels // steps, busy, max(0.0, 1.0 - busy / per_step)))
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log("    {:<38} {:8.3f} ms  {:5.1%}".format(cls, ms, ms / busy))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if kernel_class(name) in ("augmentation kernel", "gathers (dataset rows, mixup partners)"):
            log("    input path: {:8.3f} ms  {}".format(ms, name[:100]))
    return ms_aug


def phase_aug_slice():
    """Phases 10 and 10b; returns the augmentation kernel's launches over
    the eight steps of phase 10."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "packed")
        log("== phase 10: the device-resident dataset")
        write_dataset(path)
        dd = upload_dataset(path)
        trainer, launches, rows = phase_aug_train(dd)
        phase_aug_equal(dd, rows)
        phase_aug_times(trainer, dd, rows)
    return launches


def gemm_inputs(M, K, N, dtype, seed):
    """Seeded a (M,K) and b (K,N) on the card, b scaled by 1/sqrt(K)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    a = torch.randn(M, K, generator=g, device=DEVICE).to(dtype)
    b = (torch.randn(K, N, generator=g, device=DEVICE) / K ** 0.5).to(dtype)
    return a, b


def gemm_bound_ms(M, K, N, in_dtype, out_dtype, stats):
    """(ms, what bounds it) of one GEMM (with its column statistics): the
    larger of its bytes (a and b read once, y and the statistics written
    once) over the memory rate, and its 2MNK flops (3MN more for the
    statistics) over the card's rate for the input type: the fp32 cores for
    fp32 (TF32 is off), the tensor cores for bf16."""
    in_size, out_size = (2 if t == torch.bfloat16 else 4 for t in (in_dtype, out_dtype))
    n_bytes = (M * K + K * N) * in_size + M * N * out_size + (2 * N * 4 if stats else 0)
    ops = 2.0 * M * N * K + (3.0 * M * N if stats else 0.0)
    rate = BF16_FLOPS_PER_S if in_dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gemm_cases():
    """(label, M, K, N, input dtype, matmul_bn_stats' out dtype, how many on
    the flagship's path at batch 64, 0 for the other shapes)."""
    f32, b16 = torch.float32, torch.bfloat16
    cases = [("pw {}x{}->{}".format(hw, K, N), BATCH * hw, K, N, f32, f32, n)
             for hw, K, N, n in FLAGSHIP_PW]
    cases.append(("dense", *FLAGSHIP_DENSE, f32, f32, 1))
    for name, H, cin, cout in bn_fuse_ab.SHAPES:
        for out in (b16, f32):
            cases.append(("{} bf16, out {}".format(name, str(out).split(".")[1]),
                          128 * H * H, cin, cout, b16, out, 0))
    cases += [("JAX test", M, K, N, f32, f32, 0) for M, K, N in JAX_TEST_GEMMS]
    return cases


def phase_gemm():
    """matmul and matmul_bn_stats against their plain versions, then timed.
    Returns (matmul's numbers, matmul_bn_stats' numbers) over the flagship's
    20 pointwise GEMMs and its dense head at batch 64 in fp32."""
    log("== phase 11: matmul and matmul_bn_stats kernels vs plain on the card, and times "
        "(CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card_line())
    log("  limits: y within {0:g} x (|a| @ |b|) + 1e-6 of the plain version per element (plus "
        "one bf16 step, 2^-7 of |y|, for bf16 y); the statistics as phase 6b with E[y^2]; "
        "matmul_bn_stats twice bit-equal. cuBLAS is torch.matmul on the same inputs, for "
        "reference".format(GEMM_RTOL))
    keys = ("matmul", "stats", "plain", "stats_plain", "cublas")
    totals = dict.fromkeys(keys, 0.0)
    fns = {"matmul": matmul, "stats": matmul_bn_stats, "stats_plain": matmul_bn_stats_plain,
           "cublas": torch.matmul}
    calls = {k: [] for k in fns}  # the flagship's 21 GEMMs, for the profiler
    bound = {"matmul": {}, "stats": {}}
    err = {"matmul": 0.0, "stats": 0.0}
    for i, (label, M, K, N, in_dtype, out_dtype, n) in enumerate(gemm_cases()):
        a, b = gemm_inputs(M, K, N, in_dtype, seed=800 + i)
        y = matmul(a, b)
        ref = matmul_plain(a, b)
        scale = GEMM_RTOL * matmul_plain(a.abs(), b.abs()) + 1e-6
        ys, mean, var = matmul_bn_stats(a, b, out_dtype=out_dtype)
        ys2, mean2, var2 = matmul_bn_stats(a, b, out_dtype=out_dtype)
        ps, pmean, pvar = matmul_bn_stats_plain(a, b, out_dtype)
        torch.cuda.synchronize()
        require(y.dtype == torch.float32 and y.shape == (M, N) and ys.dtype == out_dtype
                and ys.shape == (M, N), "GEMM outputs {} {}".format(y.dtype, ys.dtype))
        y_err = (y - ref).abs()
        y_ratio = (y_err / scale).max().item()
        ys_err = (ys.float() - ps.float()).abs()
        ys_limit = scale + (2 ** -7 * ps.float().abs() if out_dtype == torch.bfloat16 else 0)
        ys_ratio = (ys_err / ys_limit).max().item()
        dm, dv, s_ratio = stats_errors(mean, var, pmean, pvar, pvar + pmean * pmean)
        same = torch.equal(ys, ys2) and torch.equal(mean, mean2) and torch.equal(var, var2)
        del scale, ys_limit, ref, ps
        t = {
            "matmul": cuda_ms(lambda: matmul(a, b)),
            "stats": cuda_ms(lambda: matmul_bn_stats(a, b, out_dtype=out_dtype)),
            "plain": cuda_ms(lambda: matmul_plain(a, b)),
            "stats_plain": cuda_ms(lambda: matmul_bn_stats_plain(a, b, out_dtype)),
            "cublas": cuda_ms(lambda: torch.matmul(a, b)),
        }
        mm_bound, mm_by = gemm_bound_ms(M, K, N, in_dtype, torch.float32, False)
        st_bound, st_by = gemm_bound_ms(M, K, N, in_dtype, out_dtype, True)
        log("  {} ({}x{}x{}{}): matmul max|err| {:.3e} ({:.3f} of the limit), {:.4f} ms; "
            "matmul_bn_stats y {:.3f}, mean {:.3e}, var {:.3e} ({:.3f}), repeat bit-equal {}, "
            "{:.4f} ms; plain {:.4f} / {:.4f} ms; cuBLAS {:.4f} ms; bound {:.4f} ms ({}) / "
            "{:.4f} ms ({})".format(
                label, M, K, N, ", x{} layers".format(n) if n else "", y_err.max().item(),
                y_ratio, t["matmul"], ys_ratio, dm, dv, s_ratio, same, t["stats"], t["plain"],
                t["stats_plain"], t["cublas"], mm_bound, mm_by, st_bound, st_by))
        require(y_ratio <= 1.0, "matmul disagrees with its plain version")
        require(ys_ratio <= 1.0 and s_ratio <= 1.0,
                "matmul_bn_stats disagrees with its plain version")
        require(same, "two matmul_bn_stats runs differ")
        if n:
            for k in keys:
                totals[k] += n * t[k]
            for k, fn in fns.items():
                calls[k] += [lambda fn=fn, a=a, b=b: fn(a, b)] * n
            for k, (ms, by) in (("matmul", (mm_bound, mm_by)), ("stats", (st_bound, st_by))):
                bound[k][by] = bound[k].get(by, 0.0) + n * ms
            if in_dtype == torch.float32:
                err["matmul"] = max(err["matmul"], y_err.max().item())
                err["stats"] = max(err["stats"], ys_err.max().item(), dm, dv)
    device = {k: profiled_ms(c) for k, c in calls.items()}
    log("  the flagship's 21 GEMMs, device time of their kernels (torch.profiler, host gaps "
        "left out, mean of 5): matmul {:.4f} ms, matmul_bn_stats {:.4f} ms, its plain version "
        "{:.4f} ms, cuBLAS {:.4f} ms".format(device["matmul"], device["stats"],
                                            device["stats_plain"], device["cublas"]))
    out = []
    for k, plain_key, library in (("matmul", "plain", totals["cublas"]),
                                  ("stats", "stats_plain", None)):
        total_bound = sum(bound[k].values())
        by = max(bound[k], key=bound[k].get)
        log("  flagship, 20 pointwise + dense at batch {}, fp32: {} {:.4f} ms, plain {:.4f} ms, "
            "cuBLAS {:.4f} ms; bound {:.4f} ms (mostly {}), the kernel reaches {:.1%} of it"
            .format(BATCH, "matmul" if k == "matmul" else "matmul_bn_stats", totals[k],
                    totals[plain_key], totals["cublas"], total_bound, by,
                    total_bound / totals[k]))
        out.append(dict(max_abs_err=err[k], ms=totals[k], plain_ms=totals[plain_key],
                        bound_ms=total_bound, bound_by=by, library_ms=library))
    return out


def phase_bn_fuse_ab():
    """bn_fuse_ab.run on the card; returns the launches of matmul,
    matmul_bn_stats and batch_norm_stats in that run."""
    log("== phase 12: the BN-fusion A/B (dorknet_tpu_torch.utils.bn_fuse_ab), batch 128, "
        "bf16; device ms the best of 2 rounds of the median of 5")
    log("card:", card_line())
    ab_kernels = (matmul, matmul_bn_stats, batch_norm_stats)
    for k in ab_kernels:
        k.launches = 0
    results = bn_fuse_ab.run(rounds=2, runs=5)
    torch.cuda.synchronize()
    launches = [k.launches for k in ab_kernels]
    for name, *_ in bn_fuse_ab.SHAPES:
        ms = {v: results["{}_{}_device_ms".format(name, v)]
              for v in ("torch", "cuda_fused", "cuda_split", "cuda_matmul")}
        log("  {}: torch {:.4f} ms, cuda_fused {:.4f} ms, cuda_split {:.4f} ms, matmul alone "
            "{:.4f} ms; fused speedup over torch {:.3f}; statistics rel err fused {:.3e}, split "
            "{:.3e} (gate {:g}), ok {}".format(
                name, ms["torch"], ms["cuda_fused"], ms["cuda_split"], ms["cuda_matmul"],
                results[name + "_fused_speedup"], results[name + "_cuda_fused_stats_rel_err"],
                results[name + "_cuda_split_stats_rel_err"], bn_fuse_ab.GATE,
                results[name + "_stats_ok"]))
        require(results[name + "_stats_ok"], "the A/B's statistics gate failed at " + name)
    log("  launches matmul/matmul_bn_stats/batch_norm_stats {}".format(launches))
    require(all(launches), "the A/B missed a kernel")
    return launches


def phase_accumulate():
    """Trainer.accumulate_step on a fresh flagship; returns the launches of
    its first call."""
    log("== phase 13: ResNet18 trained by Trainer.accumulate_step on the card, K={} x {}"
        .format(ACC_K, BATCH))
    net = fresh_resnet18()
    trainer = Trainer(net, SGDMomentum(net, TRAIN_LR, 0.9), ema_decay=0.999, device=DEVICE)
    X, y = train_batches(13, 2 * ACC_K, BATCH)
    # fresh batch norms: the pre-pass is one more forward, without a backward
    fresh = [DW_LAYERS * (ACC_K + 1), DW_LAYERS * ACC_K, DW_LAYERS * ACC_K,
             BN_LAYERS * (ACC_K + 1)]
    wants = (fresh, [n * ACC_K for n in TRAIN_WANT])
    launches = []
    for call, want in enumerate(wants):
        for k in TRAIN_KERNELS:
            k.launches = 0
        sl = slice(call * ACC_K, (call + 1) * ACC_K)
        loss = trainer.accumulate_step(X[sl], y[sl])
        torch.cuda.synchronize()
        got = [k.launches for k in TRAIN_KERNELS]
        launches.append(got)
        log("  call {} ({} batch norms): loss {:.6f}, launches forward/dx/dw/bn_stats {} "
            "(want {})".format(call, "fresh" if call == 0 else "set", float(loss), got, want))
        require(got == want, "the accumulate step missed a kernel")
        require(loss.shape == () and np.isfinite(float(loss)), "accumulate loss")
    require(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
            "non-finite parameters")
    xs = torch.from_numpy(X[:ACC_K]).to(DEVICE)
    ys = torch.from_numpy(y[:ACC_K]).to(DEVICE)
    ms = cuda_ms(lambda: trainer.accumulate_step(xs, ys), warmup=2, iters=5)
    log("  accumulate_step, {} x {} images on the card (CUDA events, median of 5 after 2): "
        "{:.3f} ms = {:.0f} img/s".format(ACC_K, BATCH, ms, ACC_K * BATCH / ms * 1e3))
    return launches[0]


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
    serve_launches = phase_slice(net_cpu, runner, X)
    phase_serving(runner, X)
    fwd = phase_times(runner, X)
    del runner, net_gpu, net_cpu
    bwd_err = phase_bwd_vs_plain()
    bn_err = phase_bn_stats_vs_plain()
    bn = phase_bn_stats_times()
    trainer, launches = phase_train()
    phase_train_twin()
    bwd = phase_bwd_times()
    phase_train_times(trainer)
    del trainer
    aug = phase_augment_vs_plain()
    aug_launches = phase_aug_slice()
    mm, mm_stats = phase_gemm()
    ab_launches = phase_bn_fuse_ab()
    acc_launches = phase_accumulate()

    bound_ms, bound_by = flagship_bound_ms()
    dw_bound, dw_by = flagship_bound_ms(lambda C: 9 * C * 4)
    entry = dict(route="cuda", replaces="dorknet_tpu/ops/pallas/depthwise.py:205")
    log("  launches: serving run forward {}; training run forward/dx/dw/bn_stats {}; augmented "
        "training run augment/forward/dx/dw/bn_stats {}; A/B run matmul/matmul_bn_stats/"
        "bn_stats {}; accumulate run forward/dx/dw/bn_stats {}".format(
            serve_launches, launches, aug_launches, ab_launches, acc_launches))
    log(json.dumps({"kernels": [
        dict(name="depthwise3x3", route="cuda",
             source="dorknet_tpu_torch/csrc/depthwise3x3.cu",
             replaces="dorknet_tpu/ops/pallas/depthwise.py:192",
             launches=launches[0], max_abs_err=max_err, ms=fwd["kernel"],
             plain_ms=fwd["plain"], bound_ms=bound_ms, bound_by=bound_by,
             library_ms=fwd["cudnn"]),
        dict(name="depthwise3x3_dx", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[1], max_abs_err=bwd_err["dx"], ms=bwd["dx"],
             plain_ms=bwd["dx_plain"], bound_ms=bound_ms, bound_by=bound_by,
             library_ms=bwd["dx_cudnn"], **entry),
        dict(name="depthwise3x3_dw", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[2], max_abs_err=bwd_err["dw"], ms=bwd["dw"],
             plain_ms=bwd["dw_plain"], bound_ms=dw_bound, bound_by=dw_by,
             library_ms=bwd["dw_cudnn"], **entry),
        dict(name="augment_planes_fused", route="cuda",
             source="dorknet_tpu_torch/csrc/augment_planes.cu",
             replaces="dorknet_tpu/ops/pallas/augment.py:205", launches=aug_launches[0],
             library_ms=None, **aug),
        dict(name="batch_norm_stats", route="cuda", source="dorknet_tpu_torch/csrc/bn_stats.cu",
             replaces="dorknet_tpu/ops/pallas/bn_stats.py:34", launches=launches[3],
             max_abs_err=bn_err, **bn),
        dict(name="matmul", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:26", launches=ab_launches[0], **mm),
        dict(name="matmul_bn_stats", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:78", launches=ab_launches[1],
             **mm_stats),
    ]}))
    log("card:", card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
