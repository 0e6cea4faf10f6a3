#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths and its kernels' A/B
once on one NVIDIA GPU and check them.

Usage, from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi:

    python3 chip_smoke.py

Phases (each checks its results; any failure ends the run non-zero with no
"ok" line):

1. build: compile the hand-written CUDA kernels from ``dorknet_tpu_torch/csrc``
   with nvcc (sm_90a), print the card's name and power limit and each
   kernel's registers and spills (``ptxas -v``; the pipelined GEMM's three
   tiles and the augmentation's band kernels among them), and require ``HGMMA``
   (wgmma) in the SASS of every tensor-core GEMM kernel (``cuobjdump -sass``);
2. kernel vs plain: ``depthwise3x3`` against its plain PyTorch version on the
   card at the flagship's seven depthwise shapes at batch 64, an odd 9x9x24
   (both on the channel-vector route) and a 9x9x6 (the scalar route), in
   fp32 and bf16; the vector route bit-equal to the scalar route;
3. the slice: ResNet-18-depsep at full width (225 px, 120 classes), seeded
   He-normal weights and calibrated BN statistics, served by
   ``InferenceRunner(batch_size=64, device="cuda").predict_probs`` on 150
   images (three dispatches, the last padded); every depthwise layer of every
   dispatch must launch the kernel on the channel-vector route (here and in
   every later path, fp32 and bf16 flow; in training dx and dw too), and the
   probs must match the same network's forward on CPU tensors;
4. serving: ``BatchingServer`` with 64 concurrent single-image requests and
   one 5-image request;
4b. BN-folded serving of the same network: ``InferenceRunner(fold_bn=True)``
   on the 150 images (16 depthwise launches a dispatch, all vector, no
   ``batch_norm_stats``; within 1e-4 of the unfolded runner and of the CPU
   twin's folded runner); the unfolded and folded served forwards in turns,
   fp32 and bf16 flow (events, ``device_ms``, kernels a forward, the
   elementwise class's profiler ms), and the folded forward through the
   registered op ``dorknet::depthwise3x3`` against the launch called
   directly; ``predict_iter`` against ``predict_probs`` (probs, the pinned
   rings' slots, host clock); ``BatchingServer`` over the folded runner;
   ``export_program`` at batch 64 and with a polymorphic batch, saved to a
   temporary file and reloaded by ``load_serving_artifact`` (the op in the
   graph 16 times, 16 launches a reloaded dispatch, within 1e-6 of the
   runner; batches 1, 7 and 64 from the polymorphic one; size and events
   time against the runner);
5. times (CUDA events, median of 50 after 10 warm-ups): per depthwise shape
   the kernel's two routes (in turns), the plain version and cuDNN's grouped
   conv; the 16 layers' device time (``device_ms``) of the vector route,
   the scalar route (in turns: old, new, new, old), cuDNN and the vector
   route at each strip width; the served forward at batch 64 in fp32 and in
   bf16 flow;
6. backward kernels vs plain: ``depthwise3x3_dx`` and ``depthwise3x3_dw``,
   each on both routes, against their plain PyTorch versions at the same
   shapes, in fp32 and bf16; dx's channel-vector route bit-equal to its
   scalar route at every strip width; two dw runs bit-equal on each route;
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
   ``batch_norm_stats`` 34 times, and give a finite loss; then one step in
   bf16 flow. Then a CPU twin:
   two steps at batch 4 (with clip and EMA) on the card and on the CPU must
   agree;
8. training times: per depthwise shape the dx and dw kernels against their
   plain versions and cuDNN's grouped-conv backward (TF32 off); the 16
   layers' device time of both routes of each (in turns: old, new, new,
   old), cuDNN's dx and dw alone and dx at each strip width, fp32 and bf16;
   ``Trainer.step`` at batch 64 in fp32 and in bf16 flow; a
   ``torch.profiler`` breakdown of the fp32 step by kernel class;
9. augmentation kernel vs plain: ``augment_planes_fused`` (the band route)
   against its plain PyTorch version on the card at the flagship's batch (60
   precrops of 281x281 uint8 -> 225x225) in six configurations (crop random
   or center, with and without HSV and rotation, crop only, no crop) and at
   100x100 with a margin P = 35 (>= 33) whose table holds angles to +-90
   degrees (the second shear of a bottom band reads the top rows): bit-equal
   to the plain version and to the plane route, two runs bit-equal; at the
   flagship configuration the band and plane routes in turns (events and
   device time), the band route's tile sizes, the plain version and the
   bound;
10. the augmented training slice: a synthetic packed directory (2,048
    images of 281x281, 120 classes) uploaded by ``DeviceResidentDataset``
    in 64 MB chunks, with the peak device memory held to the dataset plus
    one chunk; ResNet-18-depsep at full width trained by five
    ``Trainer.step_augmented_indexed`` steps (the flagship's augmentation,
    mixup, 120 images a step) and one ``multi_step_augmented_indexed`` of
    three, and one step in bf16 flow; every step must launch the
    augmentation kernel once, the depthwise forward, dx and dw kernels 16
    times each and ``batch_norm_stats`` 34 times, with a finite loss.
    Then, under one generator seed, ``step_augmented``,
    ``train_pipeline`` + ``Trainer.step`` and ``step_augmented_indexed``
    must agree;
10b. times of the augmented step against ``Trainer.step`` on an
    already-augmented batch of 120, and a ``torch.profiler`` split of the
    augmented step;
11. GEMM: ``matmul`` and ``matmul_bn_stats`` against their plain versions
    at the flagship's 20 pointwise GEMMs and its dense head at batch 64 in
    fp32 (every one on the pipelined CUDA-core route, y bit-equal to the
    classic ``cuda_core`` route's), the BN-fusion A/B's two shapes in bf16
    (y in bf16 and in fp32) and the JAX package's test shapes in fp32 (the
    pipelined route) and bf16 (the tensor-core route); two
    ``matmul_bn_stats`` runs bit-equal; each timed against its plain version
    and cuBLAS; at each fp32 flagship shape the pipelined and classic routes'
    device time in turns (old, new, new, old) beside cuBLAS's and each of
    the pipelined route's three tiles, summed over the 21 GEMMs with their
    bound shares; at the A/B's shapes both bf16
    routes in turns (events and device time), against their bounds and
    ``torch.mm(out_dtype=float32)`` / ``torch.matmul`` in bf16;
12. the BN-fusion A/B (``dorknet_tpu_torch.utils.bn_fuse_ab.run``): the
    torch, fused and split variants' ms per shape (CUDA events) and their
    kernels' device time, its 2e-2 statistics gate, and the route its GEMMs
    took (the tensor cores);
13. ``Trainer.accumulate_step`` on a fresh flagship, K = 2 micro-batches of
    64: the BN pre-pass and the two micro-batches launch
    ``batch_norm_stats`` 34 x 3 times, the depthwise forward 48 and dx and
    dw 32 each, with a finite loss; a second call without the pre-pass, one
    in bf16 flow, and its time;
13b. the captured steps (the trainer's default on the card; phases 7-13
    run ``cuda_graph=False``, the eager path, whose per-step launch counts
    they check): ``Trainer.step`` at batch 64, ``step_augmented_indexed``
    on phase 10's resident dataset (60 rows + mixup) and
    ``accumulate_step`` (K = 2 x 64), each captured trainer held against an
    eager twin from the same seed over three replays (under deterministic
    cuDNN: with its default algorithms two eager trainers part within a
    step, which the phase logs first): loss, every parameter, running stat
    and EMA leaf bit-equal, or
    within 1e-4 relative + 1e-5 absolute, the line saying which held; a
    ``torch.profiler`` profile of one replay of each must hold the vector
    depthwise forward, dx and dw 16 times each and ``bn_stats_partial``
    34 times by kernel name (twice that in the accumulate step, and one
    band augmentation kernel in the augmented step): a replay moves no
    launch counter; a ``StepDecay`` change between replays reaches the
    replay with no recapture, a momentum change captures a new graph;
    eager and captured in turns in one call (events around the step,
    busy ms, kernels, wrapper launches and idle share from a profile, and
    each capture's seconds), a step's peak memory and the graph pool's
    size; one eager step each of ``remat`` False, True and "blocks"
    (equal losses, peak memory, busy ms, launches).

The line before the last is a JSON object of the kernels of the paths (with
each kernel's launches by route, and both routes' times, device times
included; the depthwise forward's entry also carries its launches in the
folded served run and in the reloaded programs' runs; every entry its
launches in one replay of each captured step, by name in the profile, and
the training kernels their wrapper launches over phase 13b's driven
steps); a JSON object of phase 13b's numbers comes before it; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import os
import re
import shutil
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
from dorknet_tpu_torch.layers import BatchNormLayer
from dorknet_tpu_torch.network import (BatchingServer, InferenceRunner, Trainer,
                                       load_serving_artifact)
from dorknet_tpu_torch.ops.augment import shear_pad
from dorknet_tpu_torch.ops.cuda.augment import (
    BAND_COLS, BAND_ROWS, _geometry, augment_param_table, augment_planes_fused,
    augment_planes_fused_plain, launch_augment_kernel)
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats, batch_norm_stats_plain
import dorknet_tpu_torch.ops.cuda.depthwise as dw_mod
from dorknet_tpu_torch.ops.cuda.build import load_library
from dorknet_tpu_torch.ops.cuda.depthwise import (
    _dw_route, _dwgrad_route, _dx_route, depthwise3x3, depthwise3x3_dw, depthwise3x3_dw_plain,
    depthwise3x3_dx, depthwise3x3_dx_plain, depthwise3x3_plain, launch_dw, launch_dx,
    launch_forward)
from dorknet_tpu_torch.ops.cuda.matmul import (
    PIPELINED_TILES, _gemm_route, _gemm_tile, launch_matmul, launch_matmul_bn_stats, matmul,
    matmul_bn_stats, matmul_bn_stats_plain, matmul_plain)
from dorknet_tpu_torch.optimisers import SGDMomentum
from dorknet_tpu_torch.serving_artifact import deserialize
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
SCALAR_DW = [(9, 6, 1), (9, 6, 2)]  # C not a multiple of 4: the scalar route
DW_STRIPS = (1, 2, 4, 8)  # the vector route's strip widths, timed in phase 5
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
# the band route's tiles (output rows, columns), timed against each other in phase 9
AUG_BAND_TILES = [(29, 57), (32, 64), (38, 75), (45, 75), (57, 75), (45, 113)]


_START = time.perf_counter()


def log(*args):
    """Print a line; a phase's heading carries the seconds since the start."""
    if args and str(args[0]).startswith("== "):
        args = ("[{:.1f} s]".format(time.perf_counter() - _START),) + args
    print(*args, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise CheckFailed(what)


def reset_launches(kernels):
    """Set each kernel's launch count, and its counts per route, to 0."""
    for k in kernels:
        k.launches = 0
        for route in getattr(k, "launches_by_route", {}):
            k.launches_by_route[route] = 0


def route_counts(kernels=KERNELS):
    """A copy of each kernel's launches by route."""
    return [dict(k.launches_by_route) for k in kernels]


def require_vector_route(what, before=None, kernels=(depthwise3x3,)):
    """Every launch of each of ``kernels`` since ``before`` (their
    ``route_counts``; default 0) took the channel-vector route, and each of
    them launched at least once."""
    before = before or [dict.fromkeys(k.launches_by_route, 0) for k in kernels]
    for k, b in zip(kernels, before, strict=True):
        by = k.launches_by_route
        delta = {r: by[r] - b[r] for r in by}
        log("  {}: {} launches by route {}".format(what, k.__name__, delta))
        require(delta["scalar"] == 0 and delta["vector"] > 0,
                "{}: a depthwise layer missed {}'s channel-vector route".format(
                    what, k.__name__))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup=10, iters=50):
    """Median device time of one call of fn, from CUDA events."""
    return measure_device_ms(fn, runs=iters, warmup=warmup)


def device_ms(calls, repeats=5, inner=None):
    """Device ms of one pass over ``calls`` (thunks), with the host's gaps
    between launches taken out: a spin kernel holds the card while the host
    queues a pass behind it, so the pass runs back to back between two CUDA
    events; the mean of ``repeats`` passes after one warm-up pass. It counts
    the card's own gap between queued kernels (about a µs each). A pass is
    queued alone because the card takes only about a thousand pending
    launches; a short list is repeated within a pass up to 20 calls (``inner`` sets
    the repeats: 1 for a call of a hundred kernels or more, such as a forward), so the
    events' own few µs weigh little. If the spin ended before the host had
    queued the pass, it spins longer and measures again. (torch.profiler's
    kernel records, summed, dropped some kernels in some profiling sessions
    on an H100 host.)"""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    inner = inner or max(1, 20 // len(calls))
    total, spin = 0.0, 20_000_000  # cycles: about 10 ms
    for _ in range(repeats):
        for _ in range(4):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(inner):
                for fn in calls:
                    fn()
            end.record()
            queued_ahead = not start.query()  # the spin still held the card
            torch.cuda.synchronize()
            if queued_ahead:
                break
            spin *= 4
        else:
            raise CheckFailed("the host could not queue {} calls ahead of the card".format(
                len(calls)))
        total += start.elapsed_time(end)
    return total / repeats / inner


def dw_inputs(N, H, C, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(N, H, H, C, generator=g, device=DEVICE).to(dtype)
    w = torch.randn(C, 3, 3, generator=g, device=DEVICE)
    if dtype == torch.bfloat16:
        # bf16-exact weights: every product is exact in fp32, so the kernel
        # and the plain version round the same fp32 sums
        w = w.to(torch.bfloat16).float()
    return x, w


def sass_hgmma(path):
    """(the tensor-core GEMM kernels in the library, how many of them have
    HGMMA, the SASS of wgmma, in their code), from cuobjdump -sass."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if "matmul_tc_kernel" in f.split("\n", 1)[0]]
    return len(funcs), sum("HGMMA" in f for f in funcs)


_TEMPLATE_ARGS = [(r"13__nv_bfloat16", "bf16"), (r"Li(\d+)E", None),
                  (r"Lb([01])E", None), (r"f", "fp32"),
                  (r"j", "u32"), (r"l", "i64"), (r"i", "int"), (r"b", "bool")]


def kernel_label(mangled):
    """'name<args>' of a mangled kernel name, its template arguments read for
    the types and integers the port's kernels take."""
    pos = 3 if mangled.startswith("_ZN") else 2  # the nested names, length-prefixed
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            return mangled
        start = pos + m.end()
        name = mangled[start:start + int(m.group())]
        pos = start + len(name)
        if not name.endswith("kernel"):
            continue
        rest, args = mangled[pos:], []
        if rest.startswith("I"):
            rest = rest[1:]
            while rest and not rest.startswith("E"):
                for pat, label in _TEMPLATE_ARGS:
                    t = re.match(pat, rest)
                    if t:
                        args.append(label or t.group(1))
                        rest = rest[t.end():]
                        break
                else:
                    args.append(rest)
                    break
        return "{}<{}>".format(name, ",".join(args)) if args else name


def ptxas_report(compiler_log):
    """(kernel, registers, spill bytes) of each entry function in nvcc's
    ``-Xptxas -v`` output."""
    out, name, spills = [], None, 0
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = kernel_label(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name = None
    return out


def phase_build():
    log("== phase 1: build")
    log("card:", card_line())
    kernels = load_library()
    log("build: nvcc {:.2f} s -> {}".format(kernels.build_seconds, kernels.path))
    report = ptxas_report(kernels.compiler_log)
    for name, regs, spills in report:
        log("ptxas: {:<48} {:>3} registers, {} bytes spilled".format(name, regs, spills))
    for kernel in ("matmul_pipelined_kernel", "augment_band_kernel"):
        require(any(name.startswith(kernel) for name, _, _ in report),
                "no ptxas report of {}".format(kernel))
    n_tc, n_hgmma = sass_hgmma(kernels.path)
    log("  SASS: {} tensor-core GEMM kernels, {} with HGMMA".format(n_tc, n_hgmma))
    require(n_tc == 4 and n_hgmma == n_tc, "the tensor-core GEMM's SASS lacks HGMMA")


def phase_kernel_vs_plain():
    """Returns the largest fp32 max-abs error at the flagship's shapes."""
    log("== phase 2: depthwise3x3 kernel vs plain on the card; the channel-vector route "
        "against the scalar route, bit-equal")
    worst = 0.0
    cases = [(H, C, s, BATCH) for H, C, s, _ in FLAGSHIP_DW] + \
            [(H, C, s, 4) for H, C, s in ODD_DW + SCALAR_DW]
    for i, (H, C, stride, N) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = dw_inputs(N, H, C, dtype, seed=i)
            route = _dw_route(x)
            y = depthwise3x3(x, w, stride)
            ys = launch_forward(x, w, stride, "scalar")
            ref = depthwise3x3_plain(x, w, stride)
            torch.cuda.synchronize()
            require(y.dtype == dtype and y.shape == ref.shape,
                    "output {} {}".format(y.dtype, tuple(y.shape)))
            require(route == ("scalar" if C % 4 else "vector"),
                    "{}x{}x{} took the {} route".format(H, H, C, route))
            same = bool(torch.equal(y, ys))
            require(same, "the {} route differs from the scalar route".format(route))
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if dtype == torch.float32:
                limit = 1e-5 * scale + 1e-6
                if N == BATCH:
                    worst = max(worst, err)
            else:
                limit = 1e-2
            log("  N={} {}x{}x{} s{} {}: {} route, bit-equal to the scalar route {}; max|err| "
                "{:.3e} (limit {:.3e}, max|y| {:.3f})".format(
                    N, H, H, C, stride, str(dtype).split(".")[1], route, same, err, limit,
                    scale))
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
    reset_launches((depthwise3x3, batch_norm_stats))
    probs = runner.predict_probs(X)
    torch.cuda.synchronize()
    require_vector_route("served run")
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


def serve_concurrently(runner, X):
    """BatchingServer over ``runner``: BATCH single-image requests from as
    many threads, then one of 5 rows. Returns the dispatches."""
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
    return dispatches


def phase_serving(runner, X):
    log("== phase 4: BatchingServer")
    serve_concurrently(runner, X)


ELEMENTWISE = "elementwise and reductions"  # kernel_class's name for them


def forward_times(fwds, x):
    """Each of ``fwds`` (name -> test-mode forward) on x, the variants in
    turns (a, b, b, a): the mean of the events' medians and of the device
    times, then a profile of 5 calls each. Returns name -> dict(events,
    device, kernels, busy, idle, elementwise, gemm, dw_forward): ms a call,
    and the idle share of the profiled span."""
    names = list(fwds)
    ev, dev = {k: [] for k in names}, {k: [] for k in names}
    for k in names + names[::-1]:
        ev[k].append(cuda_ms(lambda f=fwds[k]: f(x)))
        dev[k].append(device_ms([lambda f=fwds[k]: f(x)], inner=1))
    out = {}
    for k in names:
        span, by_class, _, n_kernels = device_profile(lambda f=fwds[k]: f(x), steps=5)
        busy = sum(by_class.values())
        out[k] = dict(events=statistics.mean(ev[k]), device=statistics.mean(dev[k]),
                      kernels=n_kernels, busy=busy, idle=max(0.0, 1.0 - busy / span),
                      elementwise=by_class.get(ELEMENTWISE, 0.0),
                      gemm=by_class.get("GEMM", 0.0),
                      dw_forward=by_class.get("depthwise forward", 0.0))
    return out


def enqueue_us(fn, calls=200):
    """Host µs to queue one call of fn (no synchronisation inside the
    window; the card takes about a thousand pending launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def direct_forward(fn):
    """fn() with ``depthwise3x3`` calling the forward's launch directly
    instead of through the registered op ``dorknet::depthwise3x3``: the
    dispatcher's host cost, A/B'd on the same network."""
    saved = dw_mod.depthwise3x3_op
    dw_mod.depthwise3x3_op = dw_mod._forward
    try:
        return fn()
    finally:
        dw_mod.depthwise3x3_op = saved


def phase_folded(net_cpu, runner, X):
    """BN-folded serving of the same network. Returns the depthwise
    kernel's launches in the folded served run and in the reloaded
    artifacts' runs, for the kernels line."""
    log("== phase 4b: BN-folded serving: InferenceRunner(fold_bn=True), its forward beside the "
        "unfolded one, predict_iter, BatchingServer and the exported program")
    card = card_line()
    log("card:", card)
    dispatches = -(-X.shape[0] // BATCH)
    want = runner.predict_probs(X)
    folded = InferenceRunner(runner._source, batch_size=BATCH, device=DEVICE, fold_bn=True)
    require(not any(isinstance(l, BatchNormLayer) for l in folded.network.modules()),
            "a batch norm was left in the folded network")
    reset_launches((depthwise3x3, batch_norm_stats))
    probs = folded.predict_probs(X)
    torch.cuda.synchronize()
    served = dict(launches=depthwise3x3.launches,
                  launches_by_route=dict(depthwise3x3.launches_by_route))
    require_vector_route("folded served run")
    log("  {} images, {} dispatches: depthwise3x3 launches {} (want {}), batch_norm_stats {} "
        "(want 0)".format(X.shape[0], dispatches, served["launches"], DW_LAYERS * dispatches,
                          batch_norm_stats.launches))
    require(served["launches"] == DW_LAYERS * dispatches, "a depthwise layer missed the kernel")
    require(batch_norm_stats.launches == 0, "the folded forward took batch statistics")
    cpu = InferenceRunner(net_cpu, batch_size=8, device="cpu", fold_bn=True).predict_probs(X[:8])
    err_u = float(np.abs(probs - want).max())
    err_c = float(np.abs(probs[:8] - cpu).max())
    log("  max|dprob| vs the unfolded runner {:.3e}, vs the CPU twin's folded runner on 8 images "
        "{:.3e} (limit 1e-4 each)".format(err_u, err_c))
    require(err_u <= 1e-4 and err_c <= 1e-4, "the folded runner disagrees")

    # the served forward, unfolded and folded, in one call
    x64 = torch.from_numpy(X[:BATCH]).to(DEVICE)
    fwds = {"unfolded": runner.network._test_fn, "folded": folded.network._test_fn}
    times = {}
    with torch.inference_mode():
        times["fp32"] = forward_times(fwds, x64)
        before = route_counts((depthwise3x3,))
        times["bf16"] = bf16_flow(lambda: forward_times(fwds, x64))
        torch.cuda.synchronize()
        require_vector_route("served forwards, bf16 flow", before)
        op_ab = {"op": [], "direct": []}
        for k in ("op", "direct", "direct", "op"):
            f = lambda: cuda_ms(lambda: folded.network._test_fn(x64))  # noqa: E731
            op_ab[k].append(f() if k == "op" else direct_forward(f))
        xs, ws = dw_inputs(BATCH, 7, 512, torch.float32, seed=7)
        host = {"op": [], "direct": []}
        for k in ("op", "direct", "direct", "op"):
            fn = dw_mod.depthwise3x3_op if k == "op" else dw_mod._forward
            host[k].append(enqueue_us(lambda fn=fn: fn(xs, ws, 1)))
    log("  served forward, batch {} (events: median of 50 after 10 warm-ups; device: "
        "device_ms; the variants in turns unfolded, folded, folded, unfolded):".format(BATCH))
    for dt in ("fp32", "bf16"):
        for k in fwds:
            t = times[dt][k]
            busy = t["busy"] or float("nan")
            log("    {} {:<8}: events {:.3f} ms = {:.0f} img/s; device {:.3f} ms; {} kernels, "
                "busy {:.3f} ms (profiler; idle share {:.1%}), elementwise {:.3f} ms ({:.1%}), "
                "GEMM {:.3f} ms ({:.1%}), depthwise forward {:.3f} ms ({:.1%})".format(
                    dt, k, t["events"], BATCH / t["events"] * 1e3, t["device"], t["kernels"],
                    t["busy"], t["idle"], t["elementwise"], t["elementwise"] / busy, t["gemm"],
                    t["gemm"] / busy, t["dw_forward"], t["dw_forward"] / busy))
    op_ms, direct_ms = statistics.mean(op_ab["op"]), statistics.mean(op_ab["direct"])
    log("  the op's host cost: folded forward events {:.3f} ms through dorknet::depthwise3x3, "
        "{:.3f} ms calling the launch directly (in turns {}); queueing one 7x7x512 call: "
        "{:.1f} µs through the op, {:.1f} µs direct".format(
            op_ms, direct_ms, {k: [round(v, 4) for v in op_ab[k]] for k in op_ab},
            statistics.mean(host["op"]), statistics.mean(host["direct"])))

    # predict_iter over the same images, with labels passed through
    labels = np.arange(X.shape[0], dtype=np.int64)

    def stream():
        return ((X[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, X.shape[0], BATCH))

    reset_launches((depthwise3x3,))
    out = list(folded.predict_iter(stream()))
    torch.cuda.synchronize()
    iter_launches = depthwise3x3.launches
    iter_probs = np.concatenate([o[0] for o in out])
    iter_err = float(np.abs(iter_probs - probs).max())
    rest_ok = all(o[1].device.type == "cuda" and np.array_equal(o[1].cpu().numpy(), lab)
                  for o, (_, lab) in zip(out, stream(), strict=True))
    ins, outs = folded.pinned_rings
    log("  predict_iter: {} batches, max|dprob| vs predict_probs {:.3e} (limit 1e-6), "
        "depthwise3x3 launches {}; pinned rings: inputs {} slots ({} buffers pinned), probs {} "
        "slots ({} pinned)".format(len(out), iter_err, iter_launches, ins.slots,
                                   ins.allocations, outs.slots, outs.allocations))
    require(iter_probs.shape == probs.shape and iter_err <= 1e-6,
            "predict_iter disagrees with predict_probs")
    require(rest_ok, "predict_iter did not pass the labels through")
    require(iter_launches == DW_LAYERS * dispatches, "predict_iter missed the kernel")
    require(ins.slots == 3 and ins.allocations == 2 * ins.slots and outs.slots == 2
            and outs.allocations == outs.slots, "the pinned rings were not reused")
    t = {"iter": [], "loop": []}
    for _ in range(3):
        for k in ("iter", "loop", "loop", "iter"):
            t0 = time.perf_counter()
            if k == "iter":
                list(folded.predict_iter(stream()))
            else:
                [folded.predict_probs(b) for b, _ in stream()]
            t[k].append((time.perf_counter() - t0) * 1e3)
    log("  host clock over the {} images (median of 6, in turns): predict_iter {:.3f} ms, a "
        "predict_probs loop over the same batches {:.3f} ms".format(
            X.shape[0], statistics.median(t["iter"]), statistics.median(t["loop"])))

    log("  BatchingServer over the folded runner:")
    served["server_dispatches"] = serve_concurrently(folded, X)

    # the exported program, fixed and polymorphic, reloaded in this process
    exported = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, poly in (("fixed", False), ("polymorphic", True)):
            path = os.path.join(tmp, kind + ".pt2")
            t0 = time.perf_counter()
            blob = folded.export_program(IMAGE[1:], channels=IMAGE[0], path=path,
                                         polymorphic_batch=poly)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            art = load_serving_artifact(path, max_batch=BATCH)
            load_s = time.perf_counter() - t0
            with open(path + ".meta.json") as f:
                meta = json.load(f)
            ops = sum(n.target is torch.ops.dorknet.depthwise3x3.default
                      for n in deserialize(blob).graph.nodes)
            require(ops == DW_LAYERS, "the {} program calls the op {} times".format(kind, ops))
            require(meta["platforms"] == ["cuda"] and art.polymorphic_batch == poly,
                    "artifact meta {}".format(meta))
            reset_launches((depthwise3x3,))
            p = art.predict_probs(X)
            torch.cuda.synchronize()
            launches = depthwise3x3.launches
            require_vector_route("reloaded {} program".format(kind))
            # rows computed at the runner's batch, and the polymorphic one's
            # ragged last chunk (another batch size)
            full = dispatches - 1 if X.shape[0] % BATCH else dispatches
            err = float(np.abs(p[:full * BATCH] - probs[:full * BATCH]).max())
            err_tail = float(np.abs(p[full * BATCH:] - probs[full * BATCH:]).max())
            log("  {} artifact: {} bytes ({:.1f} MB), export {:.2f} s, load {:.2f} s; {} op calls "
                "in the graph; predict_probs on {} images: depthwise3x3 launches {} (want {}), "
                "max|dprob| vs the runner {:.3e} at its batch, {:.3e} on the last {} rows".format(
                    kind, len(blob), len(blob) / 1e6, export_s, load_s, ops, X.shape[0],
                    launches, DW_LAYERS * dispatches, err, err_tail,
                    X.shape[0] - full * BATCH))
            require(launches == DW_LAYERS * dispatches,
                    "the reloaded program missed the kernel")
            require(max(err, err_tail) <= 1e-6, "the reloaded program disagrees with the runner")
            exported[kind] = dict(bytes=len(blob), launches=launches, art=art)
        poly = exported["polymorphic"]["art"]
        for n in (1, 7, BATCH):
            before = depthwise3x3.launches
            pn = poly(torch.from_numpy(X[:n]).to(DEVICE)).cpu().numpy()
            err = float(np.abs(pn - probs[:n]).max())
            log("  polymorphic artifact at batch {}: shape {}, depthwise3x3 launches {}, "
                "max|dprob| vs the runner {:.3e}".format(n, pn.shape, depthwise3x3.launches - before,
                                                         err))
            require(pn.shape == (n, NUM_CLASSES) and depthwise3x3.launches - before == DW_LAYERS,
                    "the polymorphic artifact failed at batch {}".format(n))
            # another batch size than the runner's picks other GEMM and conv
            # algorithms, which sum in another order
            require(err <= 1e-5, "the polymorphic artifact disagrees at batch {}".format(n))
        fixed = exported["fixed"]["art"]
        with torch.inference_mode():
            ab = forward_times({"runner": folded.network._test_fn, "artifact": fixed}, x64)
    log("card:", card)
    log("  folded forward, batch {} (in turns): runner events {:.3f} ms, device {:.3f} ms, {} "
        "kernels; the reloaded fixed artifact events {:.3f} ms, device {:.3f} ms, {} kernels"
        .format(BATCH, ab["runner"]["events"], ab["runner"]["device"], ab["runner"]["kernels"],
                ab["artifact"]["events"], ab["artifact"]["device"], ab["artifact"]["kernels"]))
    return dict(folded_serving_launches=served["launches"],
                folded_serving_launches_by_route=served["launches_by_route"],
                exported_launches={k: v["launches"] for k, v in exported.items()})


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
    """Returns the kernel's (both routes), the plain version's and cuDNN's ms
    summed over the flagship's 16 depthwise layers at batch 64, fp32: CUDA
    events around each call, and the kernels' device time."""
    card = card_line()
    log("== phase 5: times (CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card)
    log("  depthwise 3x3, batch {}, fp32 unless noted; 'kernel' is the channel-vector route, "
        "'scalar' the scalar route (events in turns: scalar, vector, vector, scalar); cuDNN is "
        "F.conv2d(groups=C) on the channels-last view, for reference".format(BATCH))
    keys = ("kernel", "scalar", "plain", "cudnn", "kernel_bf16")
    totals = dict.fromkeys(keys, 0.0)
    # the 16 layers' calls, for device time: the routes in fp32 and bf16, cuDNN
    calls = {k: [] for k in ("vector", "scalar", "cudnn", "vector_bf16", "scalar_bf16",
                             "cudnn_bf16")}
    total_bytes = 0
    with torch.inference_mode():
        for i, (H, C, stride, n_layers) in enumerate(FLAGSHIP_DW):
            x, w = dw_inputs(BATCH, H, C, torch.float32, seed=100 + i)
            xb = x.to(torch.bfloat16)
            xc, wc = x.permute(0, 3, 1, 2), w.unsqueeze(1)
            xcb, wcb = xb.permute(0, 3, 1, 2), wc.to(torch.bfloat16)
            turns = {"vector": [], "scalar": []}
            for route in ("scalar", "vector", "vector", "scalar"):
                turns[route].append(cuda_ms(lambda r=route: launch_forward(x, w, stride, r)))
            t = {
                "kernel": statistics.mean(turns["vector"]),
                "scalar": statistics.mean(turns["scalar"]),
                "plain": cuda_ms(lambda: depthwise3x3_plain(x, w, stride)),
                "cudnn": cuda_ms(lambda: F.conv2d(xc, wc, stride=stride, padding=1,
                                                  groups=C)),
                "kernel_bf16": cuda_ms(lambda: depthwise3x3(xb, w, stride)),
            }
            for route in ("vector", "scalar"):
                calls[route] += [lambda x=x, w=w, s=stride, r=route:
                                 launch_forward(x, w, s, r)] * n_layers
                calls[route + "_bf16"] += [lambda x=xb, w=w, s=stride, r=route:
                                           launch_forward(x, w, s, r)] * n_layers
            for tw in DW_STRIPS:
                for dt, xx in (("", x), ("_bf16", xb)):
                    calls.setdefault("tw{}{}".format(tw, dt), []).extend(
                        [lambda x=xx, w=w, s=stride, tw=tw:
                         launch_forward(x, w, s, "vector", tw)] * n_layers)
            calls["cudnn"] += [lambda x=xc, w=wc, s=stride, C=C:
                               F.conv2d(x, w, stride=s, padding=1, groups=C)] * n_layers
            calls["cudnn_bf16"] += [lambda x=xcb, w=wcb, s=stride, C=C:
                                    F.conv2d(x, w, stride=s, padding=1, groups=C)] * n_layers
            nbytes = dw_bytes(BATCH, H, C, stride)
            total_bytes += n_layers * nbytes
            for k in totals:
                totals[k] += n_layers * t[k]
            log("  {}x{}x{} s{} (x{} layers): kernel {:.4f} ms ({:.0f} GB/s), scalar {:.4f} ms, "
                "plain {:.4f} ms, cuDNN {:.4f} ms, kernel bf16 {:.4f} ms".format(
                    H, H, C, stride, n_layers, t["kernel"], nbytes / t["kernel"] / 1e6,
                    t["scalar"], t["plain"], t["cudnn"], t["kernel_bf16"]))
        # device time of the 16 layers, the routes in turns (old, new, new, old)
        device = {k: [] for k in calls}
        for route in ("scalar", "vector", "vector", "scalar"):
            for k in (route, route + "_bf16"):
                device[k].append(device_ms(calls[k]))
        for k in calls:
            if not device[k]:  # cuDNN and the strip widths, once each
                device[k].append(device_ms(calls[k]))
    dev = {k: statistics.mean(v) for k, v in device.items()}
    bound_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    log("  16 layers per batch of {}: kernel {:.4f} ms, scalar {:.4f} ms, plain {:.4f} ms, "
        "cuDNN {:.4f} ms, kernel bf16 {:.4f} ms".format(
            BATCH, totals["kernel"], totals["scalar"], totals["plain"], totals["cudnn"],
            totals["kernel_bf16"]))
    log("  the same 16 layers, device time (calls queued behind a spin kernel, host gaps "
        "left out, mean of 5; routes in turns {}): fp32 vector {:.4f} ms, scalar {:.4f} ms, cuDNN "
        "{:.4f} ms; bf16 vector {:.4f} ms, scalar {:.4f} ms, cuDNN {:.4f} ms".format(
            {k: [round(v, 4) for v in device[k]] for k in ("vector", "scalar")},
            dev["vector"], dev["scalar"], dev["cudnn"], dev["vector_bf16"], dev["scalar_bf16"],
            dev["cudnn_bf16"]))
    log("  the vector route at each strip width for all 16 layers, device ms (the route "
        "picks dw_strip's): fp32 {}; bf16 {}".format(
            {tw: round(dev["tw{}".format(tw)], 4) for tw in DW_STRIPS},
            {tw: round(dev["tw{}_bf16".format(tw)], 4) for tw in DW_STRIPS}))
    log("  fp32 bytes bound: {:.1f} MB per batch -> {:.4f} ms at 3.35 TB/s; device time "
        "reaches {:.1%} of it (vector route), {:.1%} (scalar route), {:.1%} (cuDNN); bf16 "
        "bound {:.4f} ms, the vector route reaches {:.1%}".format(
            total_bytes / 1e6, bound_ms, bound_ms / dev["vector"], bound_ms / dev["scalar"],
            bound_ms / dev["cudnn"], bound_ms / 2, bound_ms / 2 / dev["vector_bf16"]))
    totals.update(device_vector=dev["vector"], device_scalar=dev["scalar"],
                  device_cudnn=dev["cudnn"], device_vector_bf16=dev["vector_bf16"],
                  device_scalar_bf16=dev["scalar_bf16"], device_cudnn_bf16=dev["cudnn_bf16"])

    log("card:", card)
    net = runner.network
    x64 = torch.from_numpy(X[:BATCH]).to(DEVICE)
    with torch.inference_mode():
        ms32 = cuda_ms(lambda: net._test_fn(x64))
        p32 = net._test_fn(x64).float()
        config.set_compute_dtype(torch.bfloat16)
        try:
            before = route_counts((depthwise3x3,))
            ms16 = cuda_ms(lambda: net._test_fn(x64))
            p16 = net._test_fn(x64).float()
            torch.cuda.synchronize()
            require_vector_route("served forward, bf16 flow", before)
        finally:
            config.set_compute_dtype(torch.float32)
    dprob = (p16 - p32).abs().max().item()
    log("  served forward, batch {} (device time of _test_fn): fp32 {:.3f} ms/batch = "
        "{:.0f} img/s; bf16 flow {:.3f} ms/batch = {:.0f} img/s, max|dprob| vs fp32 {:.3e}"
        .format(BATCH, ms32, BATCH / ms32 * 1e3, ms16, BATCH / ms16 * 1e3, dprob))
    with torch.inference_mode():
        per_call, by_class, _, n_kernels = device_profile(lambda: net._test_fn(x64), steps=5)
    busy = sum(by_class.values())
    if busy:
        log("  profiler, served forward fp32 (host clock with the profiler on: {:.3f} ms a "
            "batch): {} kernels, busy {:.3f} ms, idle share {:.1%}; {}".format(
                per_call, n_kernels, busy, max(0.0, 1.0 - busy / per_call),
                ", ".join("{} {:.3f} ms ({:.1%})".format(cls, ms, ms / busy) for cls, ms in
                          sorted(by_class.items(), key=lambda kv: -kv[1]))))
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
    """Returns the largest fp32 max-abs errors of dx and dw (their routed
    kernels) at the flagship's shapes."""
    log("== phase 6: depthwise3x3_dx and depthwise3x3_dw kernels, both routes, vs plain on "
        "the card")
    log("  limits: dx as the forward (fp32 1e-5*max|dx|+1e-6; bf16 1e-2, equal sums "
        "expected), its vector route bit-equal to its scalar route at every strip width {}; "
        "dw 2e-5*sum|x*g| per tap and channel + 1e-6 on each route, each route twice "
        "bit-equal".format(DW_STRIPS))
    worst = {"dx": 0.0, "dw": 0.0}
    cases = [(H, C, s, BATCH) for H, C, s, _ in FLAGSHIP_DW] + \
            [(H, C, s, 4) for H, C, s in ODD_DW + SCALAR_DW]
    for i, (H, C, stride, N) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = dw_inputs(N, H, C, dtype, seed=200 + i)
            g = grad_input(N, H, C, stride, dtype, seed=300 + i)
            routes = (_dx_route(g), _dwgrad_route(x, g))
            want = "scalar" if C % 4 else "vector"
            require(routes == (want, want), "{}x{}x{} took the dx/dw routes {}".format(
                H, H, C, routes))
            dx = depthwise3x3_dx(g, w, stride, H, H)
            dxs = launch_dx(g, w, stride, H, H, "scalar")
            strips = [launch_dx(g, w, stride, H, H, "vector", tw) for tw in DW_STRIPS] \
                if want == "vector" else []
            ref = depthwise3x3_dx_plain(g, w, stride, H, H)
            dw = depthwise3x3_dw(x, g, stride)
            dws = {r: (launch_dw(x, g, stride, r), launch_dw(x, g, stride, r))
                   for r in (("scalar", "vector") if want == "vector" else ("scalar",))}
            dw_ref = depthwise3x3_dw_plain(x, g, stride)
            scale = depthwise3x3_dw_plain(x.float().abs(), g.float().abs(), stride)
            torch.cuda.synchronize()
            require(dx.dtype == dtype and dx.shape == x.shape,
                    "dx {} {}".format(dx.dtype, tuple(dx.shape)))
            require(dw.dtype == torch.float32 and dw.shape == (C, 3, 3),
                    "dw {} {}".format(dw.dtype, tuple(dw.shape)))
            dx_same = all(torch.equal(v, dxs) for v in [dx] + strips)
            dx_err = (dx.float() - ref.float()).abs().max().item()
            dx_scale = ref.float().abs().max().item()
            dx_limit = 1e-5 * dx_scale + 1e-6 if dtype == torch.float32 else 1e-2
            dw_limit = 2e-5 * scale + 1e-6
            dw_err = (dw - dw_ref).abs().max().item()
            dw_ratio = {r: ((a - dw_ref).abs() / dw_limit).max().item() for r, (a, _) in dws.items()}
            dw_same = {r: bool(torch.equal(a, b)) for r, (a, b) in dws.items()}
            routed_same = bool(torch.equal(dw, dws[want][0]))
            if dtype == torch.float32 and N == BATCH:
                worst["dx"] = max(worst["dx"], dx_err)
                worst["dw"] = max(worst["dw"], dw_err)
            log("  N={} {}x{}x{} s{} {}: {} routes; dx max|err| {:.3e} (limit {:.3e}), the scalar "
                "route, {} strip widths and the routed call bit-equal {}; dw max|err| {:.3e}, "
                "share of its limit by route {}, each route twice bit-equal {}".format(
                    N, H, H, C, stride, str(dtype).split(".")[1], want, dx_err, dx_limit,
                    len(strips), dx_same, dw_err, {r: round(v, 4) for r, v in dw_ratio.items()},
                    dw_same))
            require(dx_err <= dx_limit, "depthwise3x3_dx disagrees with its plain version")
            require(dx_same, "the dx routes or strip widths differ")
            require(all(v <= 1.0 for v in dw_ratio.values()),
                    "depthwise3x3_dw disagrees with its plain version")
            require(all(dw_same.values()) and routed_same, "two depthwise3x3_dw runs differ")
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
    device = {k: device_ms(c) for k, c in calls.items()}
    log("  the same 34 calls, device time (calls queued behind a spin kernel, host gaps left "
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


def bf16_flow(fn):
    """fn() under the bf16 compute policy, then back to fp32."""
    config.set_compute_dtype(torch.bfloat16)
    try:
        return fn()
    finally:
        config.set_compute_dtype(torch.float32)


def phase_train():
    """Returns the trainer, the launches of each kernel over its three fp32
    steps, and the depthwise kernels' launches by route in them."""
    log("== phase 7: ResNet18 trained by Trainer.step on the card (eager)")
    net = fresh_resnet18()
    trainer = Trainer(net, SGDMomentum(net, TRAIN_LR, 0.9), ema_decay=0.999, device=DEVICE,
                      cuda_graph=False)
    X, y = train_batches(2, 3, BATCH)
    reset_launches(TRAIN_KERNELS)
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
    routes = route_counts()
    require_vector_route("training run", kernels=KERNELS)
    before = [k.launches for k in TRAIN_KERNELS]
    loss16, _ = bf16_flow(lambda: trainer.step(X[0], y[0]))
    torch.cuda.synchronize()
    per_step = [k.launches - b for k, b in zip(TRAIN_KERNELS, before)]
    log("  a step in bf16 flow: loss {:.6f}, launches forward/dx/dw/bn_stats {}".format(
        float(loss16), per_step))
    require(per_step == TRAIN_WANT, "a bf16-flow step missed a kernel")
    require(np.isfinite(float(loss16)), "non-finite bf16-flow loss")
    require_vector_route("training step, bf16 flow", routes, KERNELS)
    require(all(l.bn_initialized() for l in net.layers), "a batch norm was not initialised")
    require(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
            "non-finite parameters")
    require(all(bool(torch.isfinite(e).all()) for e in trainer._ema), "non-finite EMA")
    log("  3 steps at batch {}: launches forward/dx/dw/bn_stats {} (want {})".format(
        BATCH, launches, [3 * n for n in TRAIN_WANT]))
    return trainer, launches, routes


def phase_train_twin():
    """Two steps at batch 4 on the card and on the CPU from the same fresh
    weights, with clip and EMA; returns nothing, raises on a mismatch."""
    log("== phase 7b: the same training on the CPU (batch 4, clip 1.0, EMA 0.9)")
    X, y = train_batches(3, 2, 4)
    trainers = []
    for device in (DEVICE, "cpu"):
        net = fresh_resnet18()
        trainers.append(Trainer(net, SGDMomentum(net, 0.05 * 4 / 200.0, 0.9),
                                ema_decay=0.9, clip_norm=1.0, device=device, cuda_graph=False))
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
    """Returns {name: ms} summed over the flagship's 16 depthwise layers at
    batch 64: CUDA events around each call (fp32 unless named), and the
    device time of both routes, cuDNN and dx's strip widths (``device_*``)."""
    log("== phase 8: backward kernel times (CUDA events, median of 50 after 10 warm-ups; "
        "device time of the 16 layers)")
    log("card:", card_line())
    log("  depthwise 3x3 backward, batch {}, fp32 unless noted; cuDNN is "
        "aten.convolution_backward of F.conv2d(groups=C) on the channels-last "
        "views, dx alone and dw alone, for reference; torch.backends.cudnn.allow_tf32 = {} "
        "(TF32 off: cuDNN computes the same fp32 function)".format(
            BATCH, torch.backends.cudnn.allow_tf32))
    require(not torch.backends.cudnn.allow_tf32, "cuDNN's yardstick would run in TF32")
    keys = ("dx", "dx_plain", "dx_cudnn", "dx_bf16", "dw", "dw_plain", "dw_cudnn", "dw_bf16")
    totals = dict.fromkeys(keys, 0.0)
    calls = {}  # the 16 layers' calls, for device time

    def add(key, n, fn):
        calls.setdefault(key, []).extend([fn] * n)

    for i, (H, C, stride, n) in enumerate(FLAGSHIP_DW):
        x, w = dw_inputs(BATCH, H, C, torch.float32, seed=400 + i)
        g = grad_input(BATCH, H, C, stride, torch.float32, seed=500 + i)
        xb, gb, wb = x.to(torch.bfloat16), g.to(torch.bfloat16), w.to(torch.bfloat16)
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
            totals[k] += n * t[k]
        nbytes = dw_bytes(BATCH, H, C, stride)
        log("  {}x{}x{} s{} (x{}): dx {:.4f} ms ({:.0f} GB/s), plain {:.4f}, cuDNN {:.4f}, "
            "bf16 {:.4f} | dw {:.4f} ms ({:.0f} GB/s), plain {:.4f}, cuDNN {:.4f}, "
            "bf16 {:.4f}".format(
                H, H, C, stride, n, t["dx"], nbytes / t["dx"] / 1e6, t["dx_plain"],
                t["dx_cudnn"], t["dx_bf16"], t["dw"], nbytes / t["dw"] / 1e6,
                t["dw_plain"], t["dw_cudnn"], t["dw_bf16"]))
        for dt, xx, gg, ww in (("", x, g, w), ("_bf16", xb, gb, wb)):
            for r in ("scalar", "vector"):
                add("dx_" + r + dt, n, lambda g=gg, w=w, s=stride, H=H, r=r:
                    launch_dx(g, w, s, H, H, r))
                add("dw_" + r + dt, n, lambda x=xx, g=gg, s=stride, r=r: launch_dw(x, g, s, r))
            for tw in DW_STRIPS:
                add("dx_tw{}{}".format(tw, dt), n, lambda g=gg, w=w, s=stride, H=H, tw=tw:
                    launch_dx(g, w, s, H, H, "vector", tw))
            add("dx_cudnn" + dt, n, lambda g=gg, x=xx, w=ww, s=stride:
                cudnn_grad(g, x, w, s, [True, False, False]))
            add("dw_cudnn" + dt, n, lambda g=gg, x=xx, w=ww, s=stride:
                cudnn_grad(g, x, w, s, [False, True, False]))
    # the routes in turns (old, new, new, old), then cuDNN and the strip widths
    device = {k: [] for k in calls}
    for route in ("scalar", "vector", "vector", "scalar"):
        for k in ("dx_", "dw_"):
            for dt in ("", "_bf16"):
                device[k + route + dt].append(device_ms(calls[k + route + dt]))
    for k in calls:
        if not device[k]:
            device[k].append(device_ms(calls[k]))
    dev = {k: statistics.mean(v) for k, v in device.items()}
    bound, by = flagship_bound_ms()
    for k in ("dx", "dw"):
        log("  {} over 16 layers per batch of {}, events: kernel {:.4f} ms, plain {:.4f} ms, "
            "cuDNN {:.4f} ms, kernel bf16 {:.4f} ms".format(
                k, BATCH, totals[k], totals[k + "_plain"], totals[k + "_cudnn"],
                totals[k + "_bf16"]))
        log("  {} device time (calls queued behind a spin kernel, host gaps left out, mean of "
            "5; routes in turns {}): fp32 vector {:.4f} ms ({:.1%} of the {:.4f} ms {} bound), "
            "scalar {:.4f} ms, cuDNN {:.4f} ms; bf16 vector {:.4f} ms ({:.1%} of {:.4f} ms), "
            "scalar {:.4f} ms, cuDNN {:.4f} ms".format(
                k, {r: [round(v, 4) for v in device["{}_{}".format(k, r)]]
                    for r in ("vector", "scalar")},
                dev[k + "_vector"], bound / dev[k + "_vector"], bound, by, dev[k + "_scalar"],
                dev[k + "_cudnn"], dev[k + "_vector_bf16"], bound / 2 / dev[k + "_vector_bf16"],
                bound / 2, dev[k + "_scalar_bf16"], dev[k + "_cudnn_bf16"]))
        for dt in ("", "_bf16"):
            totals["device_{}{}".format(k, dt)] = dev["{}_vector{}".format(k, dt)]
            totals["device_{}_scalar{}".format(k, dt)] = dev["{}_scalar{}".format(k, dt)]
            totals["device_{}_cudnn{}".format(k, dt)] = dev["{}_cudnn{}".format(k, dt)]
    log("  dx's vector route at each strip width for all 16 layers, device ms (the route "
        "picks dw_strip's): fp32 {}; bf16 {}".format(
            {tw: round(dev["dx_tw{}".format(tw)], 4) for tw in DW_STRIPS},
            {tw: round(dev["dx_tw{}_bf16".format(tw)], 4) for tw in DW_STRIPS}))
    return totals


def kernel_class(name):
    n = name.lower()
    if "augment_band" in n or "augment_rotate" in n or "augment_pointwise" in n:
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
    if "matmul_kernel" in n or "matmul_tc_kernel" in n:
        return "hand-written GEMM"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "cublas" in n:
        return "GEMM"
    if "conv" in n or "cudnn" in n or "dgrad" in n or "wgrad" in n:
        return "cuDNN conv"
    if "multi_tensor_apply" in n:
        return "optimiser, clip and EMA (_foreach)"
    return "elementwise and reductions"


def device_profile(fn, steps=3):
    """torch.profiler over ``steps`` calls of fn. Returns the host ms a call
    with the profiler on, and the device ms a call by kernel class and by
    kernel name, and the kernels a call. Device-side events only (kernels,
    copies): a CPU op's device time is the same kernels' time again."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += evt.count
        ms = evt.device_time_total / 1e3 / steps
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    return span_ms / steps, by_class, by_name, n_kernels // steps


def phase_train_times(trainer):
    """Trainer.step at batch 64 in fp32 and bf16 flow; returns the fp32 ms."""
    log("== phase 8b: Trainer.step times (CUDA events around the step, median of 10 "
        "after 3 warm-ups; batch already on the card)")
    log("card:", card_line())
    X, y = train_batches(4, 1, BATCH)
    x = torch.from_numpy(X[0]).to(DEVICE)
    yt = torch.from_numpy(y[0]).to(DEVICE)
    ms32 = cuda_ms(lambda: trainer.step(x, yt), warmup=3, iters=10)
    before = route_counts()
    ms16 = bf16_flow(lambda: cuda_ms(lambda: trainer.step(x, yt), warmup=3, iters=10))
    loss16 = float(bf16_flow(lambda: trainer.step(x, yt))[0])
    require_vector_route("Trainer.step, bf16 flow", before, KERNELS)
    require(np.isfinite(loss16), "non-finite bf16-flow loss")
    log("  Trainer.step, batch {}: fp32 {:.3f} ms = {:.0f} img/s; bf16 flow {:.3f} ms = "
        "{:.0f} img/s (loss {:.4f})".format(BATCH, ms32, BATCH / ms32 * 1e3, ms16,
                                            BATCH / ms16 * 1e3, loss16))

    per_step, by_class, by_name, n_kernels = device_profile(lambda: trainer.step(x, yt))
    busy = sum(by_class.values())
    if busy == 0.0:
        log("  profiler: no device time recorded")
        return ms32
    log("  profiler, fp32 step (host clock with the profiler on: {:.3f} ms a step): {} "
        "kernels a step, busy {:.3f} ms, idle share {:.1%}".format(
            per_step, n_kernels, busy, max(0.0, 1.0 - busy / per_step)))
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


def aug_case(x, cfg, seed, out_hw=AUG_OUT, P=None):
    """(params, table, (oh, ow), hsv_on, P, flip_on) of one augmentation
    configuration on batch x, with the margin P of its rotation range unless
    P is given."""
    B, H, W = x.shape[:3]
    params = draw_batch_params(torch.Generator(device=DEVICE).manual_seed(seed), B, (H, W),
                               out_hw, **cfg)
    oh, ow, P_cfg = _geometry(x, out_hw, cfg["rotation_tuple"], cfg["crop_mode"])
    table = augment_param_table(params, B, (H, W), (oh, ow), device=DEVICE, **cfg)
    return (params, table, (oh, ow), cfg["hsv_pert_tuples"] is not None,
            P_cfg if P is None else P, cfg["horizontal_flip_prob"] is not None)


def phase_augment_vs_plain():
    """Returns the flagship configuration's numbers: max |err| in uint8
    steps, pixels off, the band route's ms and device ms, the plane route's,
    plain ms, bound ms, what bounds it."""
    log("== phase 9: augment_planes_fused kernel vs plain on the card; the band route "
        "against the plane route")
    log("  batch {} of {}x{} uint8 -> {}; limits: bit-equal to the plain version and to the "
        "plane route, two runs bit-equal".format(AUG_BATCH, PRECROP, PRECROP, AUG_OUT))
    x = precrop_batch(AUG_BATCH, PRECROP, PRECROP, seed=9)
    result = None
    # the six configurations, and the flagship's at 100 px with a +-40 degree
    # range (P = 35 >= 33, t_hi = 127 > 2P) whose table draws angles to +-90:
    # the second shear of a bottom band then reads the top rows of the image
    cases = [(name, cfg, 90 + i, None) for i, (name, cfg) in enumerate(AUG_CONFIGS)]
    wide = dict(AUG_CFG, rotation_tuple=(-90.0, 90.0))
    cases.append(("P>=33 wrap", wide, 97, shear_pad((-40.0, 40.0), 100, 100)))
    for name, cfg, seed, P_given in cases:
        xc = x[:, :110, :110].contiguous() if P_given else x
        params, table, (oh, ow), hsv_on, P, flip_on = aug_case(
            xc, cfg, seed, (100, 100) if P_given else AUG_OUT, P_given)
        got = launch_augment_kernel(xc, table, (oh, ow), hsv_on, P) if P_given else \
            augment_planes_fused(xc, params, AUG_OUT, **cfg)
        again = launch_augment_kernel(xc, table, (oh, ow), hsv_on, P)
        plane = launch_augment_kernel(xc, table, (oh, ow), hsv_on, P, route="plane")
        want = augment_planes_fused_plain(xc, table, (oh, ow), hsv_on, P, flip_on)
        torch.cuda.synchronize()
        require(got.dtype == torch.uint8 and got.shape == want.shape,
                "output {} {}".format(got.dtype, tuple(got.shape)))
        diff = (got.int() - want.int()).abs()
        err, off = diff.max().item(), int((diff > 0).sum().item())
        same, same_plane = bool(torch.equal(got, again)), bool(torch.equal(got, plane))
        log("  {:<12} -> {}x{}, P {}: max|err| {} steps, {} of {} pixels off ({:.5%}), repeat "
            "bit-equal {}, plane route bit-equal {}".format(
                name, oh, ow, P, err, off, diff.numel(), off / diff.numel(), same, same_plane))
        require(off == 0, "augment_planes_fused's band route differs from its plain version")
        require(same, "two augment_planes_fused runs differ")
        require(same_plane, "the band route differs from the plane route")
        if name == "all":
            def run(route, tile=None):
                return launch_augment_kernel(x, table, (oh, ow), hsv_on, P, route=route,
                                             tile=tile)

            times = {r: [] for r in ("plane", "band")}
            for r in ("plane", "band", "band", "plane"):  # old, new, new, old
                times[r].append((cuda_ms(lambda: run(r)), device_ms([lambda: run(r)])))
            (ms, dev), (old_ms, old_dev) = (
                tuple(statistics.mean(t[i] for t in times[r]) for i in (0, 1))
                for r in ("band", "plane"))
            plain_ms = cuda_ms(lambda: augment_planes_fused_plain(x, table, (oh, ow), hsv_on,
                                                                  P, flip_on))
            bound, by, n_bytes = augment_bound_ms(AUG_BATCH, PRECROP, PRECROP, oh, ow, P,
                                                  cfg["crop_mode"] is not None)
            variants = {tile: device_ms([lambda tile=tile: run("band", tile)])
                        for tile in AUG_BAND_TILES}
            result = dict(max_abs_err=err, pixels_off=off, ms=ms, device_ms=dev,
                          old_route_ms=old_ms, old_route_device_ms=old_dev, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by,
                          band_tiles_device_ms={"{}x{}".format(*k): v
                                                for k, v in variants.items()})
            log("  times (CUDA events, median of 50 after 10 warm-ups; device time queued "
                "behind a spin kernel, mean of 5; routes in turns plane, band, band, plane), "
                "card: {}".format(card_line()))
            log("  flagship configuration: band route {:.4f} ms (device {:.4f}, {:.1%} of the "
                "bound), plane route {:.4f} ms (device {:.4f}), plain {:.4f} ms; bound {:.4f} "
                "ms ({}; {:.1f} MB at 3.35 TB/s)".format(
                    ms, dev, bound / dev, old_ms, old_dev, plain_ms, bound, by, n_bytes / 1e6))
            log("  band route tiles (rows x columns: device ms; the default {}x{}): {}".format(
                BAND_ROWS, BAND_COLS,
                {k: round(v, 4) for k, v in result["band_tiles_device_ms"].items()}))
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
    log("== phase 10: ResNet18 trained by Trainer.step_augmented_indexed on the card (eager)")
    trainer = fresh_aug_trainer(cuda_graph=False)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    aug = dict(AUG_CFG, mixup=MIXUP)
    want = [1] + TRAIN_WANT
    reset_launches(AUG_KERNELS)
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
    aug_routes = dict(augment_planes_fused.launches_by_route)
    log("  augmentation launches by route {}".format(aug_routes))
    require(aug_routes["band"] == launches[0] and aug_routes["plane"] == 0,
            "an augmented step missed the band route")
    require_vector_route("augmented training run", kernels=KERNELS)
    before, routes = [k.launches for k in AUG_KERNELS], route_counts()
    loss16, _ = bf16_flow(lambda: trainer.step_augmented_indexed(
        gen, dd.images, dd.labels, dd.next_indices(), AUG_OUT, dd.num_classes, **aug))
    torch.cuda.synchronize()
    per_step = [k.launches - b for k, b in zip(AUG_KERNELS, before)]
    log("  a step in bf16 flow: loss {:.6f}, launches augment/forward/dx/dw/bn_stats {}".format(
        float(loss16), per_step))
    require(per_step == want and np.isfinite(float(loss16)), "the bf16-flow step")
    require_vector_route("augmented step, bf16 flow", routes, KERNELS)
    require(all(bool(torch.isfinite(p).all()) for p in trainer.network.parameters()),
            "non-finite parameters")
    log("  8 steps of {} trained images: launches augment/forward/dx/dw/bn_stats {}".format(
        2 * AUG_BATCH, launches))
    return trainer, launches, aug_routes, rows_stack[-1]


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
                   input_layout="NHWC", device=DEVICE, cuda_graph=False)
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

    per_step, by_class, by_name, n_kernels = device_profile(aug_step)
    busy = sum(by_class.values())
    if busy == 0.0:
        log("  profiler: no device time recorded")
        return ms_aug
    log("  profiler, augmented step (host clock with the profiler on: {:.3f} ms a step): {} "
        "kernels a step, busy {:.3f} ms, idle share {:.1%}".format(
            per_step, n_kernels, busy, max(0.0, 1.0 - busy / per_step)))
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log("    {:<38} {:8.3f} ms  {:5.1%}".format(cls, ms, ms / busy))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if kernel_class(name) in ("augmentation kernel", "gathers (dataset rows, mixup partners)"):
            log("    input path: {:8.3f} ms  {}".format(ms, name[:100]))
    return ms_aug


def phase_aug_slice(path):
    """Phases 10 and 10b over a dataset packed at ``path``; returns the five
    kernels' launches over the eight steps of phase 10, the augmentation
    kernel's launches by route, and the device-resident dataset."""
    log("== phase 10: the device-resident dataset")
    write_dataset(path)
    dd = upload_dataset(path)
    trainer, launches, aug_routes, rows = phase_aug_train(dd)
    phase_aug_equal(dd, rows)
    phase_aug_times(trainer, dd, rows)
    return launches, aug_routes, dd


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
    the flagship's path at batch 64, 0 for the other shapes, whether the two
    routes are timed against each other: the A/B's bf16 shapes)."""
    f32, b16 = torch.float32, torch.bfloat16
    cases = [("pw {}x{}->{}".format(hw, K, N), BATCH * hw, K, N, f32, f32, n, False)
             for hw, K, N, n in FLAGSHIP_PW]
    cases.append(("dense", *FLAGSHIP_DENSE, f32, f32, 1, False))
    for name, H, cin, cout in bn_fuse_ab.SHAPES:
        for out in (b16, f32):
            cases.append(("{} bf16, out {}".format(name, str(out).split(".")[1]),
                          128 * H * H, cin, cout, b16, out, 0, True))
    for dtype in (f32, b16):
        cases += [("JAX test {}".format(str(dtype).split(".")[1]), M, K, N, dtype, dtype, 0,
                   False) for M, K, N in JAX_TEST_GEMMS]
    return cases


def cublas_fp32_out(a, b):
    """cuBLAS's bf16 GEMM with fp32 output, the same function as ``matmul``
    on bf16 inputs: ``torch.mm(a, b, out_dtype=torch.float32)``, or None
    where the installed torch refuses ``out_dtype``."""
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as exc:
        log("  torch.mm(out_dtype=torch.float32) refused: {}".format(str(exc)[:120]))
        return None


def route_times(fn, routes=("cuda_core", "tensor_core")):
    """{route: (event ms, device ms)} of ``fn(route)``, each the mean of two
    turns taken old, new, new, old."""
    ev, dev = {r: [] for r in routes}, {r: [] for r in routes}
    for r in routes + routes[::-1]:
        ev[r].append(cuda_ms(lambda: fn(r)))
        dev[r].append(device_ms([lambda: fn(r)]))
    return {r: (statistics.mean(ev[r]), statistics.mean(dev[r])) for r in routes}


def fp32_route_times(a, b, out_dtype, n, mm_bound, st_bound):
    """Device ms of one fp32 flagship GEMM: matmul and matmul_bn_stats on the
    pipelined and the classic CUDA-core routes in turns (old, new, new, old),
    and cuBLAS's torch.matmul; events ms beside. Logs a line."""
    routes = ("cuda_core", "cuda_core_pipelined")
    mm = route_times(lambda r: launch_matmul(a, b, r), routes)
    st = route_times(lambda r: launch_matmul_bn_stats(a, b, out_dtype, r), routes)
    lib = device_ms([lambda: torch.matmul(a, b)])
    tiles = {"{}x{}".format(*tile): device_ms([lambda tile=tile: launch_matmul(
        a, b, routes[1], tile)]) for tile in PIPELINED_TILES}
    stats_tiles = {"{}x{}".format(*tile): device_ms([lambda tile=tile: launch_matmul_bn_stats(
        a, b, out_dtype, routes[1], tile)]) for tile in PIPELINED_TILES}
    row = dict(device_ms=mm[routes[1]][1], old_route_device_ms=mm[routes[0]][1],
               ms=mm[routes[1]][0], old_route_ms=mm[routes[0]][0], library_device_ms=lib,
               bound_ms=mm_bound, stats_device_ms=st[routes[1]][1],
               stats_old_route_device_ms=st[routes[0]][1], stats_bound_ms=st_bound,
               tile="{}x{}".format(*_gemm_tile(*a.shape, b.shape[1])),
               stats_tile="{}x{}".format(*_gemm_tile(*a.shape, b.shape[1], stats=True)),
               tiles_device_ms=tiles, stats_tiles_device_ms=stats_tiles)
    log("    x{} layers, device ms: matmul pipelined {:.4f} ({:.1%} of the bound), cuda_core "
        "{:.4f}, cuBLAS {:.4f}; matmul_bn_stats pipelined {:.4f} ({:.1%}), cuda_core {:.4f}; "
        "bound {:.4f} / {:.4f}; by tile, matmul (the rule's {}) {}, matmul_bn_stats (the "
        "rule's {}) {}".format(
            n, row["device_ms"], mm_bound / row["device_ms"], row["old_route_device_ms"], lib,
            row["stats_device_ms"], st_bound / row["stats_device_ms"],
            row["stats_old_route_device_ms"], mm_bound, st_bound, row["tile"],
            {k: round(v, 4) for k, v in tiles.items()}, row["stats_tile"],
            {k: round(v, 4) for k, v in stats_tiles.items()}))
    return row


def phase_gemm():
    """matmul and matmul_bn_stats against their plain versions, then timed.
    Returns (matmul's numbers, matmul_bn_stats' numbers): over the
    flagship's 20 pointwise GEMMs and its dense head at batch 64 in fp32,
    and under "bf16" the A/B's shapes on both routes."""
    log("== phase 11: matmul and matmul_bn_stats kernels vs plain on the card, and times "
        "(CUDA events, median of 50 after 10 warm-ups)")
    log("card:", card_line())
    log("  limits: y within {0:g} x (|a| @ |b|) + 1e-6 of the plain version per element (plus "
        "one bf16 step, 2^-7 of |y|, for bf16 y); on the tensor-core route twice the ratio "
        "cuBLAS's bf16 GEMM with fp32 output reaches on the same inputs, where that is larger; "
        "the statistics as phase 6b with E[y^2]; matmul_bn_stats twice bit-equal. cuBLAS is "
        "torch.matmul on the same inputs, for reference".format(GEMM_RTOL))
    keys = ("matmul", "stats", "plain", "stats_plain", "cublas")
    totals = dict.fromkeys(keys, 0.0)
    fns = {"matmul": matmul, "stats": matmul_bn_stats, "stats_plain": matmul_bn_stats_plain,
           "cublas": torch.matmul}
    calls = {k: [] for k in fns}  # the flagship's 21 GEMMs, for the profiler
    bound = {"matmul": {}, "stats": {}}
    err = {"matmul": 0.0, "stats": 0.0}
    bf16 = {"matmul": [], "stats": []}
    per_shape = []
    reset_launches((matmul, matmul_bn_stats))
    for i, (label, M, K, N, in_dtype, out_dtype, n, ab) in enumerate(gemm_cases()):
        a, b = gemm_inputs(M, K, N, in_dtype, seed=800 + i)
        route = _gemm_route(a, b)
        require(route == ("tensor_core" if in_dtype == torch.bfloat16 else
                          "cuda_core_pipelined"), "{} took the {} route".format(label, route))
        before = (matmul.launches_by_route[route], matmul_bn_stats.launches_by_route[route])
        y = matmul(a, b)
        ref = matmul_plain(a, b)
        scale = GEMM_RTOL * matmul_plain(a.abs(), b.abs()) + 1e-6
        ys, mean, var = matmul_bn_stats(a, b, out_dtype=out_dtype)
        ys2, mean2, var2 = matmul_bn_stats(a, b, out_dtype=out_dtype)
        ps, pmean, pvar = matmul_bn_stats_plain(a, b, out_dtype)
        torch.cuda.synchronize()
        require((matmul.launches_by_route[route] - before[0],
                 matmul_bn_stats.launches_by_route[route] - before[1]) == (1, 2),
                "{}: the {} route's counters did not move".format(label, route))
        require(y.dtype == torch.float32 and y.shape == (M, N) and ys.dtype == out_dtype
                and ys.shape == (M, N), "GEMM outputs {} {}".format(y.dtype, ys.dtype))
        factor, cub = 1.0, ""
        if route == "tensor_core":
            yc = cublas_fp32_out(a, b)
            if yc is not None:
                cub_ratio = ((yc - ref).abs() / scale).max().item()
                factor = max(1.0, 2.0 * cub_ratio)
                cub = ", cuBLAS fp32-out {:.3f} of it".format(cub_ratio)
                del yc
        y_err = (y - ref).abs()
        y_ratio = (y_err / scale).max().item() / factor
        ys_err = (ys.float() - ps.float()).abs()
        ys_limit = factor * scale + (2 ** -7 * ps.float().abs()
                                     if out_dtype == torch.bfloat16 else 0)
        ys_ratio = (ys_err / ys_limit).max().item()
        dm, dv, s_ratio = stats_errors(mean, var, pmean, pvar, pvar + pmean * pmean)
        same = torch.equal(ys, ys2) and torch.equal(mean, mean2) and torch.equal(var, var2)
        if route == "cuda_core_pipelined":  # y bit-equal to the classic CUDA-core route's
            y_old = launch_matmul(a, b, "cuda_core")
            ys_old = launch_matmul_bn_stats(a, b, out_dtype, "cuda_core")[0]
            torch.cuda.synchronize()
            old_equal = torch.equal(y, y_old) and torch.equal(ys, ys_old)
            log("  {}: tiles {}x{} and, with the statistics, {}x{}; y bit-equal to the "
                "cuda_core route's (matmul and matmul_bn_stats) {}".format(
                    label, *_gemm_tile(M, K, N), *_gemm_tile(M, K, N, stats=True), old_equal))
            require(old_equal, "the pipelined route's y differs from the cuda_core route's")
            del y_old, ys_old
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
        log("  {} ({}x{}x{}{}), {} route: matmul max|err| {:.3e} ({:.3f} of the limit{}), "
            "{:.4f} ms; matmul_bn_stats y {:.3f}, mean {:.3e}, var {:.3e} ({:.3f}), repeat "
            "bit-equal {}, {:.4f} ms; plain {:.4f} / {:.4f} ms; cuBLAS {:.4f} ms; bound {:.4f} "
            "ms ({}) / {:.4f} ms ({})".format(
                label, M, K, N, ", x{} layers".format(n) if n else "", route,
                y_err.max().item(), y_ratio, cub, t["matmul"], ys_ratio, dm, dv, s_ratio, same,
                t["stats"], t["plain"], t["stats_plain"], t["cublas"], mm_bound, mm_by,
                st_bound, st_by))
        require(y_ratio <= 1.0, "matmul disagrees with its plain version")
        require(ys_ratio <= 1.0 and s_ratio <= 1.0,
                "matmul_bn_stats disagrees with its plain version")
        require(same, "two matmul_bn_stats runs differ")
        if n and in_dtype == torch.float32:
            shape_row = fp32_route_times(a, b, out_dtype, n, mm_bound, st_bound)
            per_shape.append(dict(shape=label, M=M, K=K, N=N, layers=n, **shape_row))
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
        if ab:
            shape = label.split(" ")[0]
            rows = []
            if out_dtype == torch.bfloat16:  # matmul's y is fp32 whatever the row
                has_out = cublas_fp32_out(a, b) is not None
                lib = (cuda_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)),
                       device_ms([lambda: torch.mm(a, b, out_dtype=torch.float32)])) \
                    if has_out else (None, None)
                rows.append(("matmul", "y float32", mm_bound, mm_by, lib,
                             route_times(lambda r: launch_matmul(a, b, r))))
            lib = (t["cublas"], device_ms([lambda: torch.matmul(a, b)])) \
                if out_dtype == torch.bfloat16 else (None, None)
            rows.append(("stats", "y " + str(out_dtype).split(".")[1], st_bound, st_by, lib,
                         route_times(lambda r: launch_matmul_bn_stats(a, b, out_dtype, r))))
            for k, what, b_ms, b_by, (lib_ms, lib_dev), rt in rows:
                (tc_ms, tc_dev), (cc_ms, cc_dev) = rt["tensor_core"], rt["cuda_core"]
                bf16[k].append(dict(shape=shape, M=M, K=K, N=N, y=what.split(" ")[1],
                                    ms=tc_ms, device_ms=tc_dev, old_route_ms=cc_ms,
                                    old_route_device_ms=cc_dev, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms, library_device_ms=lib_dev))
                log("    {} {}, {}: tensor cores {:.4f} ms (device {:.4f}, {:.1%} of the bound), "
                    "CUDA cores {:.4f} ms (device {:.4f}), in turns; bound {:.4f} ms ({}); {} "
                    "{} ms (device {})".format(
                        "matmul" if k == "matmul" else "matmul_bn_stats", shape, what, tc_ms,
                        tc_dev, b_ms / tc_dev, cc_ms, cc_dev, b_ms, b_by,
                        "torch.mm(out_dtype=float32)" if k == "matmul" else "torch.matmul bf16",
                        "n/a" if lib_ms is None else "{:.4f}".format(lib_ms),
                        "n/a" if lib_dev is None else "{:.4f}".format(lib_dev)))
    phase_routes = [dict(k.launches_by_route) for k in (matmul, matmul_bn_stats)]
    log("  phase 11 launches by route: matmul {}, matmul_bn_stats {}".format(*phase_routes))
    device = {k: device_ms(c) for k, c in calls.items()}
    log("  the flagship's 21 GEMMs, device time (calls queued behind a spin kernel, host "
        "gaps left out, mean of 5): matmul {:.4f} ms, matmul_bn_stats {:.4f} ms, its plain version "
        "{:.4f} ms, cuBLAS {:.4f} ms".format(device["matmul"], device["stats"],
                                            device["stats_plain"], device["cublas"]))
    sums = {k: sum(r["layers"] * r[k] for r in per_shape) for k in per_shape[0]
            if k.endswith("_ms") and not k.endswith("tiles_device_ms")}
    log("  the 21 fp32 GEMMs by shape, summed (device ms, routes in turns cuda_core, "
        "cuda_core_pipelined, cuda_core_pipelined, cuda_core): matmul pipelined {:.4f} ({:.1%} "
        "of the {:.4f} bound, {:.3f}x cuBLAS's {:.4f}), cuda_core {:.4f}; matmul_bn_stats "
        "pipelined {:.4f} ({:.1%} of the {:.4f} bound), cuda_core {:.4f}".format(
            sums["device_ms"], sums["bound_ms"] / sums["device_ms"], sums["bound_ms"],
            sums["device_ms"] / sums["library_device_ms"], sums["library_device_ms"],
            sums["old_route_device_ms"], sums["stats_device_ms"],
            sums["stats_bound_ms"] / sums["stats_device_ms"], sums["stats_bound_ms"],
            sums["stats_old_route_device_ms"]))
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
        prefix = "" if k == "matmul" else "stats_"
        out.append(dict(max_abs_err=err[k], ms=totals[k], plain_ms=totals[plain_key],
                        bound_ms=total_bound, bound_by=by, library_ms=library,
                        device_ms=device[k],
                        old_route_device_ms=sums[prefix + "old_route_device_ms"],
                        library_device_ms=sums["library_device_ms"] if k == "matmul" else None,
                        phase11_launches_by_route=phase_routes[len(out)],
                        fp32_shapes=per_shape,
                        bf16=bf16[k]))
    return out


def phase_bn_fuse_ab():
    """bn_fuse_ab.run on the card; returns the launches of matmul,
    matmul_bn_stats and batch_norm_stats in that run, and the two GEMMs'
    launches by route."""
    log("== phase 12: the BN-fusion A/B (dorknet_tpu_torch.utils.bn_fuse_ab), batch 128, "
        "bf16; device ms the best of 2 rounds of the median of 5")
    log("card:", card_line())
    ab_kernels = (matmul, matmul_bn_stats, batch_norm_stats)
    reset_launches(ab_kernels)
    results = bn_fuse_ab.run(rounds=2, runs=5)
    torch.cuda.synchronize()
    launches = [k.launches for k in ab_kernels]
    routes = [dict(k.launches_by_route) for k in (matmul, matmul_bn_stats)]
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
    log("  launches matmul/matmul_bn_stats/batch_norm_stats {}; by route: matmul {}, "
        "matmul_bn_stats {}".format(launches, *routes))
    # the A/B's times are CUDA events around one call, which the host bounds at
    # the deep shape; the kernels' own device time of each variant on the A/B's
    # inputs (seeded as bn_fuse_ab.run seeds them)
    for name, H, cin, cout in bn_fuse_ab.SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(0)
        x = torch.randn((128 * H * H, cin), generator=g, device=DEVICE).to(torch.bfloat16)
        w = torch.randn((cin, cout), generator=g, device=DEVICE).to(torch.bfloat16) * 0.05
        variants = dict(bn_fuse_ab.VARIANTS, cuda_matmul=matmul)
        dev = {v: device_ms([lambda fn=fn: fn(x, w)]) for v, fn in variants.items()}
        log("  {} device time (queued behind a spin kernel, mean of 5): {}; fastest {}".format(
            name, {v: round(ms, 4) for v, ms in dev.items()},
            min(bn_fuse_ab.VARIANTS, key=dev.get)))
    require(all(launches), "the A/B missed a kernel")
    require(routes[0]["tensor_core"] == launches[0] and routes[1]["tensor_core"] == launches[1],
            "an A/B GEMM missed the tensor-core route")
    return launches, routes


def phase_accumulate():
    """Trainer.accumulate_step on a fresh flagship; returns the launches of
    its first call."""
    log("== phase 13: ResNet18 trained by Trainer.accumulate_step on the card (eager), "
        "K={} x {}".format(ACC_K, BATCH))
    net = fresh_resnet18()
    trainer = Trainer(net, SGDMomentum(net, TRAIN_LR, 0.9), ema_decay=0.999, device=DEVICE,
                      cuda_graph=False)
    X, y = train_batches(13, 2 * ACC_K, BATCH)
    # fresh batch norms: the pre-pass is one more forward, without a backward
    fresh = [DW_LAYERS * (ACC_K + 1), DW_LAYERS * ACC_K, DW_LAYERS * ACC_K,
             BN_LAYERS * (ACC_K + 1)]
    wants = (fresh, [n * ACC_K for n in TRAIN_WANT])
    launches = []
    for call, want in enumerate(wants):
        reset_launches(TRAIN_KERNELS)
        sl = slice(call * ACC_K, (call + 1) * ACC_K)
        loss = trainer.accumulate_step(X[sl], y[sl])
        torch.cuda.synchronize()
        got = [k.launches for k in TRAIN_KERNELS]
        require_vector_route("accumulate call {}".format(call), kernels=KERNELS)
        launches.append(got)
        log("  call {} ({} batch norms): loss {:.6f}, launches forward/dx/dw/bn_stats {} "
            "(want {})".format(call, "fresh" if call == 0 else "set", float(loss), got, want))
        require(got == want, "the accumulate step missed a kernel")
        require(loss.shape == () and np.isfinite(float(loss)), "accumulate loss")
    reset_launches(TRAIN_KERNELS)
    loss16 = bf16_flow(lambda: trainer.accumulate_step(X[:ACC_K], y[:ACC_K]))
    torch.cuda.synchronize()
    got = [k.launches for k in TRAIN_KERNELS]
    log("  a call in bf16 flow: loss {:.6f}, launches forward/dx/dw/bn_stats {}".format(
        float(loss16), got))
    require(got == wants[1] and np.isfinite(float(loss16)), "the bf16-flow accumulate call")
    require_vector_route("accumulate call, bf16 flow", kernels=KERNELS)
    require(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
            "non-finite parameters")
    xs = torch.from_numpy(X[:ACC_K]).to(DEVICE)
    ys = torch.from_numpy(y[:ACC_K]).to(DEVICE)
    ms = cuda_ms(lambda: trainer.accumulate_step(xs, ys), warmup=2, iters=5)
    log("  accumulate_step, {} x {} images on the card (CUDA events, median of 5 after 2): "
        "{:.3f} ms = {:.0f} img/s".format(ACC_K, BATCH, ms, ACC_K * BATCH / ms * 1e3))
    return launches[0]


# phase 13b: the hand kernels a replay of each captured step must run, by
# kernel name (their first pass, for the two-pass kernels), and the GEMM
# kernels (csrc/matmul.cu, csrc/matmul_sm90.cu), which it must not
REPLAY_KERNELS = (("depthwise3x3_fwd_vec_kernel", DW_LAYERS), ("depthwise3x3_dx_vec_kernel",
                  DW_LAYERS), ("depthwise3x3_dw_vec_kernel", DW_LAYERS),
                  ("bn_stats_partial_kernel", BN_LAYERS))
GEMM_KERNELS = ("matmul_kernel", "matmul_pipelined_kernel", "matmul_tc_kernel")
REPLAY_WANT = REPLAY_KERNELS + tuple((name, 0) for name in GEMM_KERNELS)
GRAPH_STEPS = 3  # replays held against eager steps, per entry point
GRAPH_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_trainer.py's, if not bit-equal


def graph_pair(make=fresh_resnet18, lr=TRAIN_LR, flags=(True, False), **kwargs):
    """Two trainers of two flagships from one seed, by default a captured
    and an eager one."""
    out = []
    for flag in flags:
        net = make()
        out.append(Trainer(net, SGDMomentum(net, lr, 0.9), ema_decay=0.999, device=DEVICE,
                           cuda_graph=flag, **kwargs))
    return out


def training_state(trainer):
    """Every parameter, batch-norm running stat and EMA leaf."""
    stats = [b for m in trainer.network.modules() if isinstance(m, BatchNormLayer)
             for b in (m.running_mean, m.running_std)]
    return list(trainer.network.parameters()) + stats + list(trainer._ema)


class Agreement:
    """Captured against eager: bit-equal, or within GRAPH_TOL, or a failed
    check."""

    def __init__(self):
        self.equal, self.worst, self.worst_abs = True, 0.0, 0.0

    def add(self, got, want):
        d = (got.float() - want.float()).abs()
        self.equal = self.equal and bool((d == 0).all())
        self.worst_abs = max(self.worst_abs, float(d.max()))
        self.worst = max(self.worst, float((d / (GRAPH_TOL["atol"] + GRAPH_TOL["rtol"]
                                                 * want.float().abs())).max()))

    def trainers(self, a, b):
        for x, y in zip(training_state(a), training_state(b), strict=True):
            self.add(x.detach(), y.detach())

    def verdict(self, what):
        held = "bit-equal" if self.equal else "within 1e-4 relative + 1e-5 absolute"
        log("  {}: captured vs eager {} (max|diff| {:.3e}, {:.3f} of the limit)".format(
            what, held, self.worst_abs, self.worst))
        require(self.worst <= 1.0, "{}: the captured steps disagree with the eager ones".format(
            what))
        return held


def replay_profile(fn, names):
    """torch.profiler over one call of fn: the count of each kernel name in
    ``names`` (by prefix), every kernel, busy ms and the host ms."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    counts, total, busy = dict.fromkeys(names, 0), 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += evt.count
        busy += evt.device_time_total / 1e3
        for name in names:
            if name in evt.key:
                counts[name] += evt.count
    return counts, total, busy, span_ms


def require_replay_kernels(what, fn, want):
    """One replay of fn runs each hand kernel of ``want`` ((name, count)
    pairs) that many times, by name in its profile."""
    counts, total, busy, span = replay_profile(fn, [n for n, _ in want])
    log("  {}: one replay's profile: {} kernels, busy {:.3f} ms of {:.3f} ms; hand kernels "
        "{}".format(what, total, busy, span, counts))
    require(counts == dict(want), "{}: a replay missed a hand kernel (want {})".format(
        what, dict(want)))
    return counts


def step_times(pair, fn, what, n_images):
    """CUDA events around the step, eager and captured in turns (eager,
    captured, captured, eager), then each one's profile and its wrapper
    launches a step. Returns a dict of the numbers."""
    out = {}
    times = {"eager": [], "captured": []}
    for which in ("eager", "captured", "captured", "eager"):
        t = pair[which == "eager"]
        times[which].append(cuda_ms(lambda: fn(t), warmup=2, iters=10))
    for which in ("eager", "captured"):
        t = pair[which == "eager"]
        ms = statistics.mean(times[which])
        reset_launches(TRAIN_KERNELS)
        fn(t)
        torch.cuda.synchronize()
        launches = [k.launches for k in TRAIN_KERNELS]
        span, by_class, _, n_kernels = device_profile(lambda: fn(t))
        busy = sum(by_class.values())
        idle = max(0.0, 1.0 - busy / span) if busy else None
        out[which] = dict(ms=ms, turns=times[which], busy_ms=busy, kernels=n_kernels,
                          profiled_ms=span, idle_share=idle, launches=launches,
                          by_class=by_class)
        log("  {} {}: {:.3f} ms = {:.0f} img/s (turns {}); busy {:.3f} ms, {} kernels a step, "
            "idle share {} (host clock with the profiler on: {:.3f} ms); wrapper launches "
            "forward/dx/dw/bn_stats a step {}".format(
                what, which, ms, n_images / ms * 1e3, [round(v, 3) for v in times[which]],
                busy, n_kernels, "{:.1%}".format(idle) if idle is not None else "not measured",
                span, launches))
        log("    device ms by class: {}".format(
            {cls: round(v, 3) for cls, v in sorted(by_class.items(), key=lambda kv: -kv[1])}))
    out["speedup"] = out["eager"]["ms"] / out["captured"]["ms"]
    log("  {}: captured {:.2f}x eager (events)".format(what, out["speedup"]))
    return out


def pool_bytes(pool):
    """Bytes of the segments of the CUDA-graph memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool))


def phase_captured(dd):
    """Phase 13b. Returns the kernels' launches over its driven steps, the
    kernels a replay runs by name, and the numbers for the kernels line."""
    log("== phase 13b: captured steps (one CUDA graph replay a step) against eager steps, "
        "ResNet18 at full width, batch {}, SGDMomentum, EMA 0.999".format(BATCH))
    log("card:", card_line())
    held, result = {}, {}
    # the parity runs under deterministic cuDNN: with its default algorithms
    # two eager flagship trainers already part after a step (the stem
    # convolution's weight gradient sums in no fixed order)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pairs = captured_parity(dd, held)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    step_pair, aug_pair, acc_pair, graph_launches, replay, steps = pairs
    xs, ys, aug_step, rows, xa, ya_t = steps
    # --- times, eager and captured in turns; cuDNN's settings are in a
    # graph's key, so each trainer captures anew under the default algorithms
    graphed = step_pair[0]
    log("  times (CUDA events around the step, the mean of two turns of the median of 10 "
        "after 2 warm-ups; inputs already on the card):")
    result["step"] = step_times(step_pair, lambda t: t.step(xs[0], ys[0]), "Trainer.step",
                                BATCH)
    result["step_augmented_indexed"] = step_times(
        aug_pair, lambda t: aug_step(t, rows[0]), "step_augmented_indexed", 2 * AUG_BATCH)
    result["accumulate_step"] = step_times(
        acc_pair, lambda t: t.accumulate_step(xa[0], ya_t[0]), "accumulate_step",
        ACC_K * BATCH)
    result["capture_seconds"] = {"step": graphed.capture_seconds,
                                 "step_augmented_indexed": aug_pair[0].capture_seconds,
                                 "accumulate_step": acc_pair[0].capture_seconds}
    log("  capture seconds (host, the latest of each trainer): {}".format(
        {k: round(v, 3) for k, v in result["capture_seconds"].items()}))
    # --- memory: a step's peak over what was allocated before it
    for which, t in zip(("captured", "eager"), step_pair):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t.step(xs[0], ys[0])
        torch.cuda.synchronize()
        result.setdefault("peak_mb", {})[which] = (torch.cuda.max_memory_allocated() - base) / 1e6
    result["pool_mb"] = pool_bytes(graphed._pool) / 1e6
    log("  memory: a Trainer.step's peak over the allocated before it, captured {:.1f} MB, "
        "eager {:.1f} MB; the captured trainer's graph pool holds {:.1f} MB".format(
            result["peak_mb"]["captured"], result["peak_mb"]["eager"], result["pool_mb"]))
    result["remat"] = phase_remat(step_pair[1].network)
    result["held"] = held
    return graph_launches, replay, result


def captured_run(what, fn, steps, want):
    """fn(k) for k < steps, each the call of a captured trainer, with the
    launch counts set to 0 just before and read just after: its outputs and
    its launches augment/forward/dx/dw/bn_stats, which must be ``want``
    (its eager steps, warm-up and capture; a replay moves none)."""
    torch.cuda.synchronize()
    reset_launches(AUG_KERNELS)
    out = [fn(k) for k in range(steps)]
    torch.cuda.synchronize()
    launches = [k.launches for k in AUG_KERNELS]
    log("  {}: wrapper launches over the captured trainer's {} calls augment/forward/dx/dw/"
        "bn_stats {} (want {})".format(what, steps, launches, want))
    require(launches == want, "{}: the captured run's launches".format(what))
    require_vector_route(what, kernels=KERNELS)
    return out, launches


def captured_parity(dd, held):
    """Phase 13b's checks: each captured entry point against its eager
    twin, one replay's kernels by name, a schedule and a momentum change.
    Records in ``held`` which agreement held. The captured trainer of each
    pair takes all its steps first, counted, then its eager twin."""
    from dorknet_tpu_torch.utils.schedules import StepDecay

    step_launches = [0] + TRAIN_WANT
    launches = {}
    # --- Trainer.step: adopt, warm up and capture, then GRAPH_STEPS replays
    step_pair = graph_pair()
    X, y = train_batches(31, 2 + GRAPH_STEPS, BATCH)
    xs, ys = torch.from_numpy(X).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    graphed = step_pair[0]
    out, launches["step"] = captured_run(
        "Trainer.step", lambda k: graphed.step(xs[k], ys[k])[0], 2 + GRAPH_STEPS,
        [3 * n for n in step_launches])
    agree = Agreement()
    for k, lg in enumerate(out):
        agree.add(lg, step_pair[1].step(xs[k], ys[k])[0])
    require(graphed.captures == 1, "Trainer.step captured {} graphs".format(graphed.captures))
    log("  Trainer.step: capture {:.3f} s (host), graph pool {:.1f} MB".format(
        graphed.capture_seconds, pool_bytes(graphed._pool) / 1e6))
    agree.trainers(*step_pair)
    held["step"] = agree.verdict("Trainer.step, {} replays".format(GRAPH_STEPS))
    # --- step_augmented_indexed on the resident dataset, mixup
    aug = dict(AUG_CFG, mixup=MIXUP)
    aug_pair = graph_pair(lr=AUG_LR)
    gens = [torch.Generator(device=DEVICE).manual_seed(131) for _ in aug_pair]
    rows = [dd.next_indices() for _ in range(2 + GRAPH_STEPS)]

    def aug_step(t, r):
        return t.step_augmented_indexed(gens[aug_pair.index(t)], dd.images, dd.labels, r,
                                        AUG_OUT, dd.num_classes, **aug)

    out, launches["step_augmented_indexed"] = captured_run(
        "step_augmented_indexed", lambda k: aug_step(aug_pair[0], rows[k])[0], len(rows),
        [3 * n for n in [1] + TRAIN_WANT])
    agree = Agreement()
    for r, lg in zip(rows, out, strict=True):
        agree.add(lg, aug_step(aug_pair[1], r)[0])
    require(aug_pair[0].captures == 1, "the augmented step's captures")
    agree.trainers(*aug_pair)
    held["step_augmented_indexed"] = agree.verdict(
        "step_augmented_indexed, {} images + mixup, {} replays".format(AUG_BATCH, GRAPH_STEPS))
    # --- accumulate_step, K = 2 x 64: the first call warms up and captures
    acc_pair = graph_pair()
    Xa, ya = train_batches(32, ACC_K * (1 + GRAPH_STEPS), BATCH)
    xa = torch.from_numpy(Xa).to(DEVICE).view(1 + GRAPH_STEPS, ACC_K, *Xa.shape[1:])
    ya_t = torch.from_numpy(ya).to(DEVICE).view(1 + GRAPH_STEPS, ACC_K, *ya.shape[1:])
    # the pre-pass of a fresh network's batch norms runs one forward, then
    # the warm-up and the capture K micro-batches each
    pre_pass = [0, DW_LAYERS, 0, 0, BN_LAYERS]
    out, launches["accumulate_step"] = captured_run(
        "accumulate_step", lambda k: acc_pair[0].accumulate_step(xa[k], ya_t[k]),
        1 + GRAPH_STEPS, [p + 2 * ACC_K * n for p, n in zip(pre_pass, step_launches)])
    agree = Agreement()
    for k, lg in enumerate(out):
        agree.add(lg, acc_pair[1].accumulate_step(xa[k], ya_t[k]))
    require(acc_pair[0].captures == 1, "the accumulate step's captures")
    agree.trainers(*acc_pair)
    held["accumulate_step"] = agree.verdict("accumulate_step, K={} x {}, {} replays".format(
        ACC_K, BATCH, GRAPH_STEPS))
    # --- kernel proof: a profile of one replay, every hand kernel of the
    # step by name and no GEMM kernel (the eager twin takes the same step, so
    # the two stay equal)
    replay = {"step": require_replay_kernels(
        "Trainer.step", lambda: graphed.step(xs[0], ys[0]), REPLAY_WANT)}
    step_pair[1].step(xs[0], ys[0])
    replay["step_augmented_indexed"] = require_replay_kernels(
        "step_augmented_indexed", lambda: aug_step(aug_pair[0], rows[0]),
        (("augment_band_kernel", 1),) + REPLAY_WANT)
    replay["accumulate_step"] = require_replay_kernels(
        "accumulate_step", lambda: acc_pair[0].accumulate_step(xa[0], ya_t[0]),
        tuple((n, ACC_K * c) for n, c in REPLAY_WANT))
    # --- a schedule between replays, then a hyperparameter change
    schedule = StepDecay(TRAIN_LR, (1,), 0.1)
    agree = Agreement()
    for t_sched in range(2):
        for t in step_pair:
            schedule.apply(t.optimiser, t_sched)
        (lg, _), (le, _) = (t.step(xs[t_sched], ys[t_sched]) for t in step_pair)
        agree.add(lg, le)
    require(graphed.captures == 1, "a schedule change captured a new graph")
    agree.trainers(*step_pair)
    held["schedule"] = agree.verdict("StepDecay {} -> {} between replays, no recapture".format(
        schedule.lr_at(0), schedule.lr_at(1)))
    for t in step_pair:
        t.optimiser.momentum = 0.5
    agree = Agreement()
    for k in range(3):
        (lg, _), (le, _) = (t.step(xs[k], ys[k]) for t in step_pair)
        agree.add(lg, le)
    require(graphed.captures == 2, "a momentum change did not capture a new graph")
    agree.trainers(*step_pair)
    held["recapture"] = agree.verdict("momentum 0.9 -> 0.5: graphs captured {}".format(
        graphed.captures))
    return (step_pair, aug_pair, acc_pair, launches, replay,
            (xs, ys, aug_step, rows, xa, ya_t))


def phase_remat(net):
    """One eager step each of remat False, True and "blocks" from copies of
    one set network: the loss, the step's peak memory, busy ms and launches."""
    import copy

    log("  remat: one eager step each from one state (batch {})".format(BATCH))
    X, y = train_batches(33, 1, BATCH)
    x, yy = torch.from_numpy(X[0]).to(DEVICE), torch.from_numpy(y[0]).to(DEVICE)
    out, loss0 = {}, None
    for remat in (False, True, "blocks"):
        copied = copy.deepcopy(net)
        t = Trainer(copied, SGDMomentum(copied, TRAIN_LR, 0.9), device=DEVICE, remat=remat,
                    cuda_graph=False)
        torch.cuda.synchronize()
        reset_launches(TRAIN_KERNELS)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = t.step(x, yy)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        launches = [k.launches for k in TRAIN_KERNELS]
        _, by_class, _, n_kernels = device_profile(lambda: t.step(x, yy), steps=1)
        busy = sum(by_class.values())
        loss = float(loss)
        loss0 = loss if loss0 is None else loss0
        out[str(remat)] = dict(peak_mb=peak, busy_ms=busy, kernels=n_kernels,
                               launches=launches, loss=loss)
        log("    remat={!s:<6}: loss {:.7f}, peak {:.1f} MB, busy {:.3f} ms, {} kernels, "
            "launches forward/dx/dw/bn_stats {}".format(remat, loss, peak, busy, n_kernels,
                                                       launches))
        require(loss == loss0, "remat={} changed the loss".format(remat))
        del t
    # the blocks hold every depthwise layer and all but the stem's two batch norms
    want = {"False": [DW_LAYERS] * 3 + [BN_LAYERS],
            "True": [2 * DW_LAYERS] + [DW_LAYERS] * 2 + [2 * BN_LAYERS],
            "blocks": [2 * DW_LAYERS] + [DW_LAYERS] * 2 + [2 * BN_LAYERS - 2]}
    for remat, w in want.items():
        require(out[remat]["launches"] == w, "remat={}: launches {} (want {})".format(
            remat, out[remat]["launches"], w))
    return out


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
    folded = phase_folded(net_cpu, runner, X)
    fwd = phase_times(runner, X)
    del runner, net_gpu, net_cpu
    bwd_err = phase_bwd_vs_plain()
    bn_err = phase_bn_stats_vs_plain()
    bn = phase_bn_stats_times()
    trainer, launches, train_routes = phase_train()
    phase_train_twin()
    bwd = phase_bwd_times()
    phase_train_times(trainer)
    del trainer
    aug = phase_augment_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        aug_launches, aug_routes, dd = phase_aug_slice(os.path.join(tmp, "packed"))
        mm, mm_stats = phase_gemm()
        ab_launches, ab_routes = phase_bn_fuse_ab()
        acc_launches = phase_accumulate()
        graph_launches, replay, captured = phase_captured(dd)
        del dd

    bound_ms, bound_by = flagship_bound_ms()
    dw_bound, dw_by = flagship_bound_ms(lambda C: 9 * C * 4)
    entry = dict(route="cuda", replaces="dorknet_tpu/ops/pallas/depthwise.py:205")

    def bwd_device(k):
        """dx's or dw's device times in the kernels line."""
        return {"{}{}".format(dt, key): bwd["device_{}{}{}".format(k, suffix, dt and "_bf16")]
                for dt in ("", "bf16_")
                for key, suffix in (("device_ms", ""), ("old_route_device_ms", "_scalar"),
                                    ("library_device_ms", "_cudnn"))}

    log("  launches: serving run forward {}; training run forward/dx/dw/bn_stats {}; augmented "
        "training run augment/forward/dx/dw/bn_stats {}; A/B run matmul/matmul_bn_stats/"
        "bn_stats {}; accumulate run forward/dx/dw/bn_stats {}; captured runs "
        "augment/forward/dx/dw/bn_stats {}".format(
            serve_launches, launches, aug_launches, ab_launches, acc_launches, graph_launches))

    def replayed(*names):
        """A kernel's launches in one replay of each captured step whose
        profile counted it, by name (the sum over ``names``: the GEMMs'
        three kernels)."""
        return {entry: sum(counts[n] for n in names) for entry, counts in replay.items()
                if names[0] in counts}

    def captured_run(i):
        """AUG_KERNELS[i]'s launches in each captured trainer's own run."""
        return {entry: counts[i] for entry, counts in graph_launches.items()}

    captured_steps = {k: captured[k] for k in ("step", "step_augmented_indexed",
                                                 "accumulate_step", "capture_seconds",
                                                 "peak_mb", "pool_mb", "remat", "held")}
    log(json.dumps({"captured_steps": captured_steps}))
    log(json.dumps({"kernels": [
        dict(name="depthwise3x3", route="cuda",
             source="dorknet_tpu_torch/csrc/depthwise3x3.cu",
             replaces="dorknet_tpu/ops/pallas/depthwise.py:192",
             launches=launches[0], max_abs_err=max_err, ms=fwd["kernel"],
             plain_ms=fwd["plain"], bound_ms=bound_ms, bound_by=bound_by,
             library_ms=fwd["cudnn"], launches_by_route=train_routes[0],
             device_ms=fwd["device_vector"], old_route_ms=fwd["scalar"],
             old_route_device_ms=fwd["device_scalar"], library_device_ms=fwd["device_cudnn"],
             bf16_device_ms=fwd["device_vector_bf16"],
             bf16_old_route_device_ms=fwd["device_scalar_bf16"],
             bf16_library_device_ms=fwd["device_cudnn_bf16"],
             captured_replay_launches=replayed("depthwise3x3_fwd_vec_kernel"),
             captured_run_launches=captured_run(1), **folded),
        dict(name="depthwise3x3_dx", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[1], max_abs_err=bwd_err["dx"], ms=bwd["dx"],
             plain_ms=bwd["dx_plain"], bound_ms=bound_ms, bound_by=bound_by,
             library_ms=bwd["dx_cudnn"], launches_by_route=train_routes[1],
             captured_replay_launches=replayed("depthwise3x3_dx_vec_kernel"),
             captured_run_launches=captured_run(2), **bwd_device("dx"), **entry),
        dict(name="depthwise3x3_dw", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[2], max_abs_err=bwd_err["dw"], ms=bwd["dw"],
             plain_ms=bwd["dw_plain"], bound_ms=dw_bound, bound_by=dw_by,
             library_ms=bwd["dw_cudnn"], launches_by_route=train_routes[2],
             captured_replay_launches=replayed("depthwise3x3_dw_vec_kernel"),
             captured_run_launches=captured_run(3), **bwd_device("dw"), **entry),
        dict(name="augment_planes_fused", route="cuda",
             source="dorknet_tpu_torch/csrc/augment_planes.cu",
             replaces="dorknet_tpu/ops/pallas/augment.py:205", launches=aug_launches[0],
             launches_by_route=aug_routes, library_ms=None,
             captured_replay_launches=replayed("augment_band_kernel"),
             captured_run_launches=captured_run(0), **aug),
        dict(name="batch_norm_stats", route="cuda", source="dorknet_tpu_torch/csrc/bn_stats.cu",
             replaces="dorknet_tpu/ops/pallas/bn_stats.py:34", launches=launches[3],
             max_abs_err=bn_err, captured_replay_launches=replayed("bn_stats_partial_kernel"),
             captured_run_launches=captured_run(4), **bn),
        dict(name="matmul", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             tensor_core_source="dorknet_tpu_torch/csrc/matmul_sm90.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:26", launches=ab_launches[0],
             launches_by_route=ab_routes[0], captured_replay_launches=replayed(*GEMM_KERNELS),
             **mm),
        dict(name="matmul_bn_stats", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             tensor_core_source="dorknet_tpu_torch/csrc/matmul_sm90.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:78", launches=ab_launches[1],
             launches_by_route=ab_routes[1], captured_replay_launches=replayed(*GEMM_KERNELS),
             **mm_stats),
    ]}))
    log("card:", card_line())
    log("chip_smoke: {:.1f} s in all".format(time.perf_counter() - _START))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
