#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its checkpoints and
its flagship training script, CAM, the MNIST script and the stretch zoo
(MobileNet-V2 and -V3-Large, EfficientNet-Lite0, ResNet-50), and its
hand-written kernels once on one NVIDIA GPU, and check them: results
against plain versions and CPU twins, and launch counts. Each kernel is
timed beside its plain version and the library's; the end-to-end rates
of the benchmark's cells come from ``benchmark_torch/run.py``, whose
device timing and kernel classes this script imports.

Usage, from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi:

    python3 chip_smoke.py

Phases (each checks its results; any failure ends the run non-zero with no
"ok" line):

1. build: compile the hand-written CUDA kernels from ``dorknet_tpu_torch/csrc``
   with nvcc (sm_90a), print the card's name and power limit and each
   kernel's registers and spills (``ptxas -v``; the pipelined GEMM's two
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
9. augmentation kernel vs plain: ``augment_planes_fused`` against its plain
   PyTorch version on the card at the flagship's batch (60 precrops of
   281x281 uint8 -> 225x225) in six configurations (crop random or center,
   with and without HSV and rotation, crop only, no crop) and at 100x100
   with a margin P = 35 (>= 33) whose table holds angles to +-90 degrees
   (the second shear of a bottom band reads the top rows): bit-equal to the
   plain version, two runs bit-equal; at the flagship configuration the
   kernel (events and device time), the plain version and the bound;
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
11. GEMM: ``matmul`` and ``matmul_bn_stats`` against their plain versions
    at the flagship's 20 pointwise GEMMs and its dense head at batch 64 in
    fp32 (every one on the pipelined CUDA-core route, y bit-equal to the
    classic ``cuda_core`` route's), the BN-fusion A/B's two shapes in bf16
    (y in bf16 and in fp32) and the JAX package's test shapes in fp32 (the
    pipelined route) and bf16 (the tensor-core route); two
    ``matmul_bn_stats`` runs bit-equal; each timed against its plain version
    and cuBLAS; at each fp32 flagship shape the pipelined and classic routes'
    device time in turns (old, new, new, old) beside cuBLAS's, summed over
    the 21 GEMMs with their bound shares; at the A/B's shapes both bf16
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
    (equal losses, peak memory, busy ms, launches);
14. checkpoints, validation and the flagship script, each run with the
    launch counts set to 0 just before it and read just after:
    14a. a captured flagship trainer (``Trainer.step`` at batch 64, EMA,
    deterministic cuDNN) saved by ``utils/torch_io.save_checkpoint`` after
    two steps, two more steps taken (the first recorded), the file loaded
    into the same live trainer: the replay that follows bit-equal to the
    recorded step (loss, every parameter, running stat, momentum and EMA
    tensor), every ``data_ptr()`` kept and no new graph; a fresh network
    and trainer restored from the file take a bit-equal step; an async save
    holds the state of its call while two steps run; bytes and save, load
    and async seconds;
    14b. ``FeedForwardNetwork.test`` over a packed validation set (240
    canvases) through the threaded loader (center crop, batch 60): the
    card's accuracy equal to a CPU twin's, 16 depthwise forward launches a
    batch and no other kernel, val img/s;
    14c. the twin of the flagship script
    (``dorknet_tpu_torch/examples/imagenet_dogs_225_resnet_18_depsep.py``)
    run through ``runpy`` with ``DORKNET_DEVICE_RESIDENT=1`` and
    ``DORKNET_CKPT_FORMAT=torch`` on phase 10's packed canvases and 14b's
    validation set: 225 px, batch 60, two epochs of eight steps, EMA 0.999,
    then a restart from epoch 1's checkpoint for one epoch; each epoch's
    ``.pt`` files, the metrics JSONL (``device_resident``, finite losses,
    ``test_acc`` in [0, 1]), every kernel of the path launched, and the
    script's own img/s beside 13b's captured step's;
15. CAM and Grad-CAM (``dorknet_tpu_torch/cam.py``) on the flagship of
    phase 3 (225 px, 120 classes, seeded weights, calibrated statistics),
    16 images, top 3: ``compute_cam_scores_batch`` at ``res8`` (a test-mode
    forward for the scores, then each image's train-mode tap: 16 + 16 x 16
    depthwise forward and 16 x 34 ``batch_norm_stats`` launches),
    ``compute_gradcam_scores_batch`` at ``res8`` and at ``res4`` (8 x 3 dx
    launches, no dw) and ``compute_cam_scores`` on one image; each held to a
    CPU twin on its first images (scores within 1e-5, maps within 1e-3 where
    the CPU's map is not all 0), every running stat bit-equal after the
    phase, events, the profiler's busy ms and img/s of each call; then the
    synthetic CAM demo twin's ``main`` on the card (4 PNGs);
16. MobileNet-V2 at full width (224 px, 1,000 classes, batch 64): 16a
    served unfolded and BN-folded (17 depthwise launches a dispatch, no
    ``batch_norm_stats``; probs within 1e-4 of the CPU forward on 2 images
    and of each other; events, device ms and a profile of each forward);
    16b one eager ``Trainer.step`` of a fresh network (17 forward, 17 dx,
    17 dw, all on the vector route, and 52 ``batch_norm_stats`` launches)
    and a CPU twin at batch 4 (the loss within 1e-4; the update within 5e-2
    relative L2, beside the CPU's own spread under a 1e-6 nudge of its
    input); 16c captured steps against eager ones (three eager steps'
    launches, then replays; one replay's profile names the hand kernels
    17/17/17/52 times; times, busy ms, idle share and peak memory); 16d the
    depthwise forward, dx and dw at each of its 10 shapes held to their
    plain versions and timed (device ms) against cuDNN with TF32 off and
    the bound;
17. the MNIST twin (``dorknet_tpu_torch/examples/MNIST_basic_convnet.py``)
    through ``runpy`` on synthetic npy files in ``scripts/MNISTprepper.py``'s
    layout, one epoch of 10 steps at batch 200 and a test: its metrics line
    and its launches (``batch_norm_stats`` only, 5 a step in the trainer's
    three eager steps);
18. the second half of the stretch zoo at full width (224 px, 1,000
    classes, batch 64), through phase 16's helpers: 18a-18d MobileNet-V3-Large
    as 16a-16d (9 depthwise 3x3 launches a served dispatch, and in the
    BN-folded one 48 ``bias_act`` launches, ``V3L_BIAS``: none 16, relu 11,
    hswish 21; in every served run of phases 16 and 18 the bias passes by
    act equal the biased layers ``layers/sequence.run_layers`` counted;
    no training step of any phase launches one; an eager step
    9/9/9 and 46 ``batch_norm_stats`` launches, its CPU twin; a replay's
    profile names them; the kernels at its 8 distinct 3x3 shapes, and its 6
    5x5 layers under cuDNN, forward and backward, for the record, their
    kernels a class of their own in the served profile); 18e
    EfficientNet-Lite0 and ResNet-50 served BN-folded (7 and 0 depthwise
    launches a dispatch; probs within 1e-4 of the CPU forward), one eager
    step each (7/7/7/49 and 0/0/0/49) and the captured step's time;
19. the train-mode batch norm's kernels after its statistics (``bn_apply``,
    ``bn_bwd_reduce``, ``bn_bwd_dx``, ``csrc/bn_train.cu``) at the batch
    norms of the benchmark's two training cells (the flagship at 120
    images, MobileNet-V3-Large at 128), each distinct shape in fp32 and
    bf16: y, (mean, inv) and dx bit-equal to the plain versions, dbeta and
    dgamma within 2e-5 of their terms' magnitudes of fp64 sums, two runs
    bit-equal; device ms of each kernel alone over every layer of the step
    against the bound of its activation passes, and of the three together
    against the eager ops they replace, in turns; each wrapper's launches in
    an eager step and each kernel's in one replay of the captured step, by
    name (once a batch norm: 34 and 46);
19b. the activation after a batch norm in those kernels (``act``): at the
    training cells' BN -> ReLU and BN -> hard-swish pairs (the flagship at
    120 images, MobileNet-V3-Large at 128, ResNet-50 v1.5 at 256; shapes
    and activations recorded from one CPU train-mode forward), the fused
    kernels against the unfused pair (the kernels without an activation and
    the activation layer's ops under autograd) in turns, device ms, and the
    first layer's fused act(y) bit-equal to the unfused in fp32. Alone:
    ``python -c "import chip_smoke as cs; cs.phase_build(); cs.phase_bn_act()"``;
19c. the bias pass of the served forward (``bias_act``, ``csrc/bn_train.cu``)
    at MobileNet-V3-Large's 48 BN-folded layers (``V3L_BIAS``) at the bulk
    serving cell's batch of 256, fp32: every output bit-equal to the eager
    add and activation, and the 48 passes' device ms against their 2-pass
    bound and against the eager ops, and the host's µs to queue them, in
    turns. Alone: ``python -c "import
    chip_smoke as cs; cs.phase_build(); cs.phase_bias_act()"``;
20. the 7x7 depthwise weight gradient (``depthwise7x7_dw``,
    ``csrc/depthwise7x7_dw.cu``) at ConvNeXt-T's four stage shapes: at the
    cell's batch of 128 in fp32 (the bands the cell's step splits its strips
    into) and at batch 8 in bf16, within 1e-5 of the fp64 sum of the same
    inputs (relative to the sum of the terms' magnitudes), two runs
    bit-equal; at batch 128, fp32, each stage's device ms against its bound
    (``counts.dw_bound_ms(..., k=7)``), the plain version and cuDNN's
    ``torch.nn.grad.conv2d_weight`` (TF32 off; a yardstick the port never
    calls), and the 18 layers' sum; then ConvNeXt-T under AdamW at the
    cell's batch of 128 and 224 px: an eager ``Trainer.step`` launches the
    wrapper 18 times, and one replay of the captured step runs each of the
    kernel's two kernels 18 times by name and cuDNN's grouped weight
    gradient not at all. Alone: ``python -c "import torch;
    torch.cuda.set_device(0); import chip_smoke as cs; cs.phase_build();
    cs.phase_dw7x7()"``.

The line before the last is a JSON object of the kernels of the paths (with
the launches by route, and both routes' times, device times included, of
each kernel that has routes; the depthwise forward's entry also carries its launches in the
folded served run and in the reloaded programs' runs; every entry its
launches in one replay of each captured step, by name in the profile, and
the training kernels their wrapper launches over phase 13b's driven
steps, and every entry its launches in each run of phases 14-18 and in one
replay of phase 16's and phase 18's captured steps; phase 19's kernels their
own numbers by cell); JSON objects of phase
13b's, phases 14-18's and phases 19b's and 19c's numbers come before it; phase 20's
entry closes the kernels list; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""

import contextlib
import copy
import io
import json
import os
import re
import shutil
import statistics
import runpy
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch.harness.timing import device_ms
from benchmark_torch.harness.trace import ELEMENTWISE, kernel_class
from benchmark_torch.work.counts import AUG_HSV_OPS, AUG_LERP_OPS, AUG_SHIFT_OPS, dw_bytes
from benchmark_torch.work.counts import dw_bound_ms as dw_k_bound_ms  # any k; ours is 3x3's
from benchmark_torch.work.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S
from dorknet_tpu_torch import cam, config
from dorknet_tpu_torch.data_loading import (DeviceResidentDataset, ImageDataLoader,
                                            ImagePreprocessor, draw_batch_params,
                                            train_pipeline, write_packed_arrays)
from dorknet_tpu_torch.layers.base import to_nhwc
from dorknet_tpu_torch.examples import synthetic_cam_demo
from dorknet_tpu_torch.models import (ConvNeXt, EfficientNetLite0, MobileNetV2, MobileNetV3Large,
                                      ResNet18, ResNet50)
from dorknet_tpu_torch.layers import BatchNormLayer, HardSwish, ReLu, sequence
from dorknet_tpu_torch.network import (BatchingServer, InferenceRunner, Trainer,
                                       load_serving_artifact)
from dorknet_tpu_torch.ops.augment import shear_pad
from dorknet_tpu_torch.ops.cuda.augment import (
    _geometry, augment_param_table, augment_planes_fused, augment_planes_fused_plain,
    launch_augment_kernel)
from dorknet_tpu_torch.ops.cuda.bias_act import bias_act, bias_act_plain
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats, batch_norm_stats_plain, sm_count
from dorknet_tpu_torch.ops.cuda.bn_train import (bn_apply, bn_apply_plain, bn_bwd_dx,
                                                 bn_bwd_dx_plain, bn_bwd_reduce)
import dorknet_tpu_torch.ops.cuda.depthwise as dw_mod
import dorknet_tpu_torch.ops.norm as norm_mod
import dorknet_tpu_torch.layers.batch_norm as bn_layer_mod
from dorknet_tpu_torch.ops.cuda.build import load_library
from dorknet_tpu_torch.ops.cuda.depthwise import (
    _dw_route, _dwgrad_route, _dx_route, depthwise3x3, depthwise3x3_dw, depthwise3x3_dw_plain,
    depthwise3x3_dx, depthwise3x3_dx_plain, depthwise3x3_plain, launch_dw, launch_dx,
    launch_forward)
from dorknet_tpu_torch.ops.cuda.depthwise7x7 import depthwise7x7_dw, depthwise7x7_dw_plain
from dorknet_tpu_torch.ops.cuda.matmul import (
    _gemm_route, _gemm_tile, launch_matmul, launch_matmul_bn_stats, matmul, matmul_bn_stats,
    matmul_bn_stats_plain, matmul_plain)
from dorknet_tpu_torch.optimisers import AdamW, SGDMomentum
from dorknet_tpu_torch.serving_artifact import deserialize
from dorknet_tpu_torch.utils import bn_fuse_ab, torch_io
from dorknet_tpu_torch.utils.autotune import measure_device_ms
from dorknet_tpu_torch.utils.metrics import read_metrics
from dorknet_tpu_torch.utils.seeded import seed_serving_weights

DEVICE = "cuda"
BATCH = 64
IMAGE = (3, 225, 225)
NUM_CLASSES = 120
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
EVENTS = dict(runs=50, warmup=10)  # measure_device_ms: the median of 50 after 10 warm-ups

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
    """Set each kernel's launch count, and its counts per route and per
    activation, to 0."""
    for k in kernels:
        k.launches = 0
        for route in getattr(k, "launches_by_route", {}):
            k.launches_by_route[route] = 0
        for act in getattr(k, "launches_by_act", {}):
            k.launches_by_act[act] = 0


def require_no_bias_pass(what, before):
    """No bias pass launched since ``before`` (``bias_act.launches``): a
    training step pairs only its batch norms with their activations."""
    require(bias_act.launches == before, "{}: a training step launched bias_act".format(what))


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


DW_CUDNN = "depthwise under cuDNN"  # kernel_class's name for the 5x5 layers' kernels


def forward_times(fwds, x):
    """Each of ``fwds`` (name -> test-mode forward) on x, the variants in
    turns (a, b, b, a): the mean of the events' medians and of the device
    times, then a profile of 5 calls each. Returns name -> dict(events,
    device, kernels, busy, idle, elementwise, gemm, dw_forward, dw5): ms a
    call, and the idle share of the profiled span."""
    names = list(fwds)
    ev, dev = {k: [] for k in names}, {k: [] for k in names}
    for k in names + names[::-1]:
        ev[k].append(measure_device_ms(lambda f=fwds[k]: f(x), **EVENTS))
        dev[k].append(device_ms([lambda f=fwds[k]: f(x)], inner=1))
    out = {}
    for k in names:
        span, by_class, _, n_kernels = device_profile(lambda f=fwds[k]: f(x), steps=5)
        busy = sum(by_class.values())
        out[k] = dict(events=statistics.mean(ev[k]), device=statistics.mean(dev[k]),
                      kernels=n_kernels, busy=busy, idle=max(0.0, 1.0 - busy / span),
                      elementwise=by_class.get(ELEMENTWISE, 0.0),
                      gemm=by_class.get("GEMM", 0.0),
                      dw_forward=by_class.get("depthwise forward", 0.0),
                      dw5=by_class.get(DW_CUDNN, 0.0))
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
            f = lambda: measure_device_ms(  # noqa: E731
                lambda: folded.network._test_fn(x64), **EVENTS)
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


def dw_bound_ms(N, H, C, stride, extra_bytes=0):
    """The least time of one depthwise 3x3 pass (forward, dx or dw) at batch
    N in fp32 and H = W: the larger of its bytes (``dw_bytes``, plus
    ``extra_bytes``: dw's weight gradient) over the memory rate, and its 18
    flops per output element over the fp32 rate. Returns (ms, what bounds
    it)."""
    Ho = (H - 1) // stride + 1
    t_bytes = (dw_bytes(N, H, H, C, stride) + extra_bytes) / HBM_BYTES_PER_S
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
                turns[route].append(measure_device_ms(
                    lambda r=route: launch_forward(x, w, stride, r), **EVENTS))
            t = {
                "kernel": statistics.mean(turns["vector"]),
                "scalar": statistics.mean(turns["scalar"]),
                "plain": measure_device_ms(lambda: depthwise3x3_plain(x, w, stride), **EVENTS),
                "cudnn": measure_device_ms(
                    lambda: F.conv2d(xc, wc, stride=stride, padding=1, groups=C), **EVENTS),
                "kernel_bf16": measure_device_ms(lambda: depthwise3x3(xb, w, stride), **EVENTS),
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
            nbytes = dw_bytes(BATCH, H, H, C, stride)
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
        ms32 = measure_device_ms(lambda: net._test_fn(x64), **EVENTS)
        p32 = net._test_fn(x64).float()
        config.set_compute_dtype(torch.bfloat16)
        try:
            before = route_counts((depthwise3x3,))
            ms16 = measure_device_ms(lambda: net._test_fn(x64), **EVENTS)
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
        t = {k: measure_device_ms(lambda fn=fn: fn(x), **EVENTS) for k, fn in fns.items()}
        t["kernel_bf16"] = measure_device_ms(lambda: batch_norm_stats(xb), **EVENTS)
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
    """Returns the launches of each kernel over its three fp32 steps, and
    the depthwise kernels' launches by route in them."""
    log("== phase 7: ResNet18 trained by Trainer.step on the card (eager)")
    net = fresh_resnet18()
    trainer = Trainer(net, SGDMomentum(net, TRAIN_LR, 0.9), ema_decay=0.999, device=DEVICE,
                      cuda_graph=False)
    X, y = train_batches(2, 3, BATCH)
    reset_launches(TRAIN_KERNELS)
    bias_before = bias_act.launches
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
    require_no_bias_pass("phase 7", bias_before)
    log("  3 steps at batch {}: launches forward/dx/dw/bn_stats {} (want {}), bias_act "
        "0".format(BATCH, launches, [3 * n for n in TRAIN_WANT]))
    return launches, routes


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


def cudnn_grad(g, x, w, stride, mask, padding=1):
    """cuDNN's grouped-conv backward, the function autograd of
    F.conv2d(groups=C) calls, on the channels-last views (a yardstick only)."""
    return torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.unsqueeze(1), None,
        [stride, stride], [padding, padding], [1, 1], False, [0, 0], x.shape[3], mask)


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
            "dx": measure_device_ms(lambda: depthwise3x3_dx(g, w, stride, H, H), **EVENTS),
            "dx_plain": measure_device_ms(lambda: depthwise3x3_dx_plain(g, w, stride, H, H),
                                          **EVENTS),
            "dx_cudnn": measure_device_ms(
                lambda: cudnn_grad(g, x, w, stride, [True, False, False]), **EVENTS),
            "dx_bf16": measure_device_ms(lambda: depthwise3x3_dx(gb, w, stride, H, H), **EVENTS),
            "dw": measure_device_ms(lambda: depthwise3x3_dw(x, g, stride), **EVENTS),
            "dw_plain": measure_device_ms(lambda: depthwise3x3_dw_plain(x, g, stride), **EVENTS),
            "dw_cudnn": measure_device_ms(
                lambda: cudnn_grad(g, x, w, stride, [False, True, False]), **EVENTS),
            "dw_bf16": measure_device_ms(lambda: depthwise3x3_dw(xb, gb, stride), **EVENTS),
        }
        for k in keys:
            totals[k] += n * t[k]
        nbytes = dw_bytes(BATCH, H, H, C, stride)
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
    steps, pixels off, the kernel's ms and device ms, plain ms, bound ms,
    what bounds it."""
    log("== phase 9: augment_planes_fused kernel vs plain on the card")
    log("  batch {} of {}x{} uint8 -> {}; limits: bit-equal to the plain version, two runs "
        "bit-equal".format(AUG_BATCH, PRECROP, PRECROP, AUG_OUT))
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
        want = augment_planes_fused_plain(xc, table, (oh, ow), hsv_on, P, flip_on)
        torch.cuda.synchronize()
        require(got.dtype == torch.uint8 and got.shape == want.shape,
                "output {} {}".format(got.dtype, tuple(got.shape)))
        diff = (got.int() - want.int()).abs()
        err, off = diff.max().item(), int((diff > 0).sum().item())
        same = bool(torch.equal(got, again))
        log("  {:<12} -> {}x{}, P {}: max|err| {} steps, {} of {} pixels off ({:.5%}), repeat "
            "bit-equal {}".format(name, oh, ow, P, err, off, diff.numel(), off / diff.numel(),
                                  same))
        require(off == 0, "augment_planes_fused differs from its plain version")
        require(same, "two augment_planes_fused runs differ")
        if name == "all":
            def run():
                return launch_augment_kernel(x, table, (oh, ow), hsv_on, P)

            ms, dev = measure_device_ms(run, **EVENTS), device_ms([run])
            plain_ms = measure_device_ms(
                lambda: augment_planes_fused_plain(x, table, (oh, ow), hsv_on, P, flip_on),
                **EVENTS)
            bound, by, n_bytes = augment_bound_ms(AUG_BATCH, PRECROP, PRECROP, oh, ow, P,
                                                  cfg["crop_mode"] is not None)
            result = dict(max_abs_err=err, pixels_off=off, ms=ms, device_ms=dev,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            log("  times (CUDA events, median of 50 after 10 warm-ups; device time queued "
                "behind a spin kernel, mean of 5), card: {}".format(card_line()))
            log("  flagship configuration: kernel {:.4f} ms (device {:.4f}, {:.1%} of the "
                "bound), plain {:.4f} ms; bound {:.4f} ms ({}; {:.1f} MB at 3.35 TB/s)".format(
                    ms, dev, bound / dev, plain_ms, bound, by, n_bytes / 1e6))
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
    """Returns the launches of the five kernels over its eight steps, and
    the rows of its last step."""
    log("== phase 10: ResNet18 trained by Trainer.step_augmented_indexed on the card (eager)")
    trainer = fresh_aug_trainer(cuda_graph=False)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    aug = dict(AUG_CFG, mixup=MIXUP)
    want = [1] + TRAIN_WANT
    reset_launches(AUG_KERNELS)
    bias_before = bias_act.launches
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
    require_no_bias_pass("phase 10", bias_before)
    log("  8 steps of {} trained images: launches augment/forward/dx/dw/bn_stats {}, bias_act "
        "0".format(2 * AUG_BATCH, launches))
    return launches, rows_stack[-1]


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


def phase_aug_slice(path):
    """Phase 10 over a dataset packed at ``path``; returns the five kernels'
    launches over its eight steps, and the device-resident dataset."""
    log("== phase 10: the device-resident dataset")
    write_dataset(path)
    dd = upload_dataset(path)
    launches, rows = phase_aug_train(dd)
    phase_aug_equal(dd, rows)
    return launches, dd


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
        ev[r].append(measure_device_ms(lambda: fn(r), **EVENTS))
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
    row = dict(device_ms=mm[routes[1]][1], old_route_device_ms=mm[routes[0]][1],
               ms=mm[routes[1]][0], old_route_ms=mm[routes[0]][0], library_device_ms=lib,
               bound_ms=mm_bound, stats_device_ms=st[routes[1]][1],
               stats_old_route_device_ms=st[routes[0]][1], stats_bound_ms=st_bound,
               tile="{}x{}".format(*_gemm_tile(*a.shape, b.shape[1])),
               stats_tile="{}x{}".format(*_gemm_tile(*a.shape, b.shape[1], stats=True)))
    log("    x{} layers, device ms: matmul pipelined {:.4f} ({:.1%} of the bound), cuda_core "
        "{:.4f}, cuBLAS {:.4f}; matmul_bn_stats pipelined {:.4f} ({:.1%}), cuda_core {:.4f}; "
        "bound {:.4f} / {:.4f}".format(
            n, row["device_ms"], mm_bound / row["device_ms"], row["old_route_device_ms"], lib,
            row["stats_device_ms"], st_bound / row["stats_device_ms"],
            row["stats_old_route_device_ms"], mm_bound, st_bound))
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
            "matmul": measure_device_ms(lambda: matmul(a, b), **EVENTS),
            "stats": measure_device_ms(lambda: matmul_bn_stats(a, b, out_dtype=out_dtype),
                                       **EVENTS),
            "plain": measure_device_ms(lambda: matmul_plain(a, b), **EVENTS),
            "stats_plain": measure_device_ms(lambda: matmul_bn_stats_plain(a, b, out_dtype),
                                             **EVENTS),
            "cublas": measure_device_ms(lambda: torch.matmul(a, b), **EVENTS),
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
                lib = (measure_device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32),
                                         **EVENTS),
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
            if k.endswith("_ms")}
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
    bias_before = bias_act.launches
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
    require_no_bias_pass("phase 13", bias_before)
    require(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
            "non-finite parameters")
    xs = torch.from_numpy(X[:ACC_K]).to(DEVICE)
    ys = torch.from_numpy(y[:ACC_K]).to(DEVICE)
    ms = measure_device_ms(lambda: trainer.accumulate_step(xs, ys), runs=5, warmup=2)
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
# and the test-mode bias pass, which no training step runs
REPLAY_WANT = REPLAY_KERNELS + tuple((name, 0) for name in GEMM_KERNELS + ("bias_act_kernel",))
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


PROFILED_CALL = "chip_smoke.profiled_call"


def replay_profile(fn, names):
    """torch.profiler over two calls of fn, read for the second: the count
    of each kernel name in ``names`` (by prefix), every kernel, busy ms and
    the host ms of that call. Late in this script the profiler loses the
    first few kernels of the first graph replay it records (one batch
    norm's forward of MobileNet-V2's step: 51 of its 52 in one replay, 103
    in two), so the first call only starts the profile. The card is
    synchronised between the two, so a kernel belongs to the second call
    when it starts after that call's host range does."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.record_function(PROFILED_CALL):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == PROFILED_CALL and e.device_type == torch.autograd.DeviceType.CPU)
    counts, total, busy = dict.fromkeys(names, 0), 0, 0.0
    for evt in events:
        if (evt.device_type != torch.autograd.DeviceType.CUDA or evt.name == PROFILED_CALL
                or evt.time_range.start < start):
            continue
        total += 1
        busy += evt.time_range.elapsed_us() / 1e3
        for name in names:
            if name in evt.name:
                counts[name] += 1
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
        times[which].append(measure_device_ms(lambda: fn(t), runs=10, warmup=2))
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
    bias_before = bias_act.launches
    out = [fn(k) for k in range(steps)]
    torch.cuda.synchronize()
    launches = [k.launches for k in AUG_KERNELS]
    require_no_bias_pass(what, bias_before)
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
    # step by name and no GEMM kernel (the profile takes two steps, and the
    # eager twin the same two, so the two stay equal)
    replay = {"step": require_replay_kernels(
        "Trainer.step", lambda: graphed.step(xs[0], ys[0]), REPLAY_WANT)}
    for _ in range(2):
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


# --------------------------------------------------------------------------- #
# Phase 14: checkpoints, validation and the flagship script
# --------------------------------------------------------------------------- #
VAL_IMAGES = 2 * NUM_CLASSES  # the packed validation set of 14b and 14c
TWIN_STEPS = 8  # training steps an epoch of the flagship script in 14c
TWIN = "dorknet_tpu_torch.examples.imagenet_dogs_225_resnet_18_depsep"


def write_val_set(path):
    """VAL_IMAGES canvases of PRECROP x PRECROP, two a class, made like the
    training set."""
    labels = np.repeat(np.arange(NUM_CLASSES), VAL_IMAGES // NUM_CLASSES)
    write_packed_arrays(path, dataset_rows(labels), labels,
                        ["class{:03d}".format(c) for c in range(NUM_CLASSES)])


def live_state(trainer):
    """Every parameter, running stat, optimiser-cache and EMA tensor."""
    return training_state(trainer) + list(trainer._cache)


def require_bit_equal(what, got, want):
    require(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)),
            "{}: not bit-equal".format(what))


def phase_checkpoint(tmp):
    """Phase 14a: torch_io checkpoints of a captured flagship trainer,
    restored in place under its graph. Returns the kernels' launches over the
    phase and its numbers."""
    log("== phase 14a: a torch-native checkpoint restored in place under the captured step, "
        "ResNet18 at full width, batch {}, SGDMomentum, EMA 0.999, deterministic "
        "cuDNN".format(BATCH))
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    reset_launches(AUG_KERNELS)
    try:
        (trainer,) = graph_pair(flags=(True,))
        X, y = train_batches(41, 6, BATCH)
        xs, ys = torch.from_numpy(X).to(DEVICE), torch.from_numpy(y).to(DEVICE)
        for k in range(2):  # adoption, then warm-up and capture
            trainer.step(xs[k], ys[k])
        path = os.path.join(tmp, "step2.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch_io.save_checkpoint(path, trainer.network, trainer)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = os.path.getsize(path)
        loss3, preds3 = trainer.step(xs[2], ys[2])  # a replay
        want = [t.clone() for t in live_state(trainer)]
        trainer.step(xs[3], ys[3])
        ptrs = [t.data_ptr() for t in live_state(trainer)]
        graphs, captures = len(trainer._graphs), trainer.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch_io.load_checkpoint(path, trainer.network, trainer)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        require([t.data_ptr() for t in live_state(trainer)] == ptrs,
                "the load moved a tensor the captured step reads")
        loss, preds = trainer.step(xs[2], ys[2])
        require(len(trainer._graphs) == graphs and trainer.captures == captures,
                "the restored trainer captured a new graph")
        require(torch.equal(loss, loss3) and torch.equal(preds, preds3),
                "the replay after the load gave another loss")
        require_bit_equal("the replay after the load", live_state(trainer), want)
        log("  {} bytes ({:.2f} MB), saved in {:.3f} s, loaded in place in {:.3f} s; the "
            "replay after the load bit-equal to the recorded step 3 (loss {:.7f}), every "
            "data_ptr kept, graphs {} and captures {} unchanged".format(
                out["bytes"], out["bytes"] / 1e6, out["save_s"], out["load_s"], float(loss),
                graphs, captures))
        # a fresh network and trainer restored from the file: its first step,
        # a warm-up and a capture, is the recorded step 3
        (fresh,) = graph_pair(flags=(True,))
        torch_io.load_checkpoint(path, fresh.network, fresh)
        loss_f, _ = fresh.step(xs[2], ys[2])
        require(torch.equal(loss_f, loss3), "a fresh restored trainer took another step")
        require_bit_equal("a fresh restored trainer's step", live_state(fresh), want)
        log("  a fresh network and trainer restored from the file: the next step bit-equal")
        del fresh
        # async: the file holds the state of the call, not of the steps
        # taken while it is written
        at_save = [t.clone() for t in live_state(trainer)]
        apath = os.path.join(tmp, "async.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckptr = torch_io.save_checkpoint_async(apath, trainer.network, trainer)
        out["async_return_s"] = time.perf_counter() - t0
        for k in range(4, 6):
            trainer.step(xs[k], ys[k])
        ckptr.wait_until_finished()
        out["async_total_s"] = time.perf_counter() - t0
        torch_io.load_checkpoint(apath, trainer.network, trainer)
        require_bit_equal("the async checkpoint", live_state(trainer), at_save)
        log("  async save: returned in {:.3f} s, two steps taken while it wrote, on disk "
            "after {:.3f} s; the file holds the state of the call".format(
                out["async_return_s"], out["async_total_s"]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    launches = [k.launches for k in AUG_KERNELS]
    log("  launches over the phase augment/forward/dx/dw/bn_stats {}".format(launches))
    return trainer.network, launches, out


def phase_network_test(net, val_path):
    """Phase 14b: network.test over the packed validation set through the
    threaded loader (center crop), on the card and on a CPU twin. Returns
    the kernels' launches in the card's run and its numbers."""
    log("== phase 14b: FeedForwardNetwork.test on the card, {} validation canvases, batch {}, "
        "center crop".format(VAL_IMAGES, AUG_BATCH))
    n_batches = VAL_IMAGES // AUG_BATCH
    pp = ImagePreprocessor(AUG_OUT, crop_mode="center")
    acc, seconds = {}, {}
    cpu_net = copy.deepcopy(net).to("cpu")
    for which, network in (("cuda", net), ("cpu", cpu_net)):
        loader = ImageDataLoader(val_path, AUG_BATCH, pp, num_workers=4)
        try:
            if which == "cuda":
                torch.cuda.synchronize()
                reset_launches(AUG_KERNELS)
            t0 = time.perf_counter()
            acc[which] = network.test(loader.pull_batch(n_batches), AUG_BATCH, VAL_IMAGES)
            seconds[which] = time.perf_counter() - t0
            if which == "cuda":
                torch.cuda.synchronize()
                launches = [k.launches for k in AUG_KERNELS]
        finally:
            loader.stop_thread()
    log("  accuracy: card {}, CPU twin {}; card {:.3f} s = {:.1f} val img/s (host clock, the "
        "loader included), CPU {:.3f} s; launches augment/forward/dx/dw/bn_stats {}".format(
            acc["cuda"], acc["cpu"], seconds["cuda"], VAL_IMAGES / seconds["cuda"],
            seconds["cpu"], launches))
    require(acc["cuda"] == acc["cpu"], "network.test: the card's accuracy differs from the CPU's")
    require(launches == [0, DW_LAYERS * n_batches, 0, 0, 0],
            "network.test: want {} depthwise forward launches and no other".format(
                DW_LAYERS * n_batches))
    require_vector_route("network.test")
    return launches, dict(test_acc=acc["cuda"], seconds=seconds["cuda"],
                          val_img_s=VAL_IMAGES / seconds["cuda"])


def run_twin(env, module=TWIN):
    """A script's __main__ (the flagship script's by default) with ``env``
    set, then unset; returns its module globals. Its standard output (the
    network's repr) is dropped; its log goes to standard error."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return runpy.run_module(module, run_name="__main__")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_twin(tmp, train_path, val_path, captured_img_s):
    """Phase 14c: the twin of the flagship script run on the card
    (resident dataset, torch checkpoints), two epochs, then a restart from
    epoch 1's checkpoint for one. Returns the kernels' launches in the first
    run and its numbers."""
    log("== phase 14c: the flagship script's __main__ on the card, DORKNET_DEVICE_RESIDENT=1, "
        "DORKNET_CKPT_FORMAT=torch, 225 px, batch {}, {} steps an epoch".format(
            AUG_BATCH, TWIN_STEPS))
    dogs = os.path.join(tmp, "dogs", "ImageNet2012", "ILSVRC2012_dogs")
    os.makedirs(dogs)
    os.symlink(train_path, os.path.join(dogs, "train_img"))
    os.symlink(val_path, os.path.join(dogs, "val_img"))
    env = {"DORKNET_DATA": os.path.join(tmp, "dogs"), "DORKNET_DEVICE_RESIDENT": "1",
           "DORKNET_CKPT_FORMAT": "torch", "DORKNET_IMAGE": str(AUG_OUT[0]),
           "DORKNET_BATCH": str(AUG_BATCH), "DORKNET_EPOCHS": "3",
           "DORKNET_TRAIN_SIZE": str(2 * AUG_BATCH * TWIN_STEPS),
           "DORKNET_VAL_SIZE": str(VAL_IMAGES), "DORKNET_WORKERS": "4",
           "DORKNET_EMA": "0.999", "DORKNET_EXPERIMENT": "ChipDogs"}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        torch.cuda.synchronize()
        reset_launches(AUG_KERNELS)
        t0 = time.perf_counter()
        run = run_twin(env)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [k.launches for k in AUG_KERNELS]
        captures = run["trainer"].captures
        del run
        exp = os.path.join(tmp, "ChipDogs")
        files = sorted(os.listdir(exp))
        log("  two epochs in {:.1f} s (script, upload and checkpoints included); graphs "
            "captured {}; launches augment/forward/dx/dw/bn_stats {}; files {}".format(
                seconds, captures, launches, files))
        ckpt = {e: [f for f in files if f.startswith("epoch_{}_testacc_".format(e))
                    and f.endswith(".pt")] for e in (1, 2)}
        require(all(len(v) == 1 for v in ckpt.values()), "an epoch's .pt checkpoint is missing")
        require(all(os.path.exists(os.path.join(exp, "epoch_{}_ema.pt".format(e)))
                    for e in (1, 2)), "an epoch's EMA checkpoint is missing")
        require(all(k > 0 for k in launches), "a kernel of the script's path never launched")
        metrics_path = os.path.join(tmp, "logging", "ChipDogs.metrics.jsonl")
        recs = read_metrics(metrics_path)
        losses = [r["loss"] for r in recs if "loss" in r]
        epochs = [r for r in recs if "test_acc" in r]
        require(recs and all(r["device_resident"] is True for r in recs),
                "the metrics do not say device_resident")
        require(losses and all(np.isfinite(losses)), "a logged loss is not finite")
        require(len(epochs) == 2 and all(0.0 <= r["test_acc"] <= 1.0 for r in epochs),
                "the epochs' test_acc")
        # the restart from epoch 1's checkpoint, for one epoch
        t0 = time.perf_counter()
        run_twin(dict(env, DORKNET_RESTART_CKPT=ckpt[1][0], DORKNET_START_EPOCH="2"))
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        recs = read_metrics(metrics_path)[len(recs):]
        require(recs and np.isfinite(recs[0]["loss"]) and recs[0]["epoch"] == 2,
                "the restarted run's first logged loss")
        require(any("test_acc" in r for r in recs), "the restarted run did not validate")
    finally:
        os.chdir(cwd)
    twin_img_s = epochs[1]["train_img_s"]
    log("  restart from {} for one epoch in {:.1f} s; its first loss {:.6f}".format(
        ckpt[1][0], restart_s, recs[0]["loss"]))
    log("  the script's own loop, epoch 2 (no capture in it): {:.1f} img/s; epoch 1 (adoption, "
        "warm-up and capture in it): {:.1f} img/s; phase 13b's captured "
        "step_augmented_indexed in this call {:.1f} img/s: the script at {:.1%} of it "
        "(its host work: a float(loss) and the preds fetched every step)".format(
            twin_img_s, epochs[0]["train_img_s"], captured_img_s, twin_img_s / captured_img_s))
    return launches, dict(seconds=seconds, restart_s=restart_s, captures=captures,
                          test_acc=[r["test_acc"] for r in epochs],
                          train_img_s=[r["train_img_s"] for r in epochs],
                          captured_img_s=captured_img_s, losses=losses)


def phase_14(tmp, train_path, captured_img_s):
    """Phases 14a-14c; returns each one's launches of AUG_KERNELS, the GEMM
    kernels' launches over the three (none) and the numbers."""
    reset_launches((matmul, matmul_bn_stats))
    net, ckpt_launches, ckpt = phase_checkpoint(tmp)
    val_path = os.path.join(tmp, "val_packed")
    write_val_set(val_path)
    test_launches, test = phase_network_test(net, val_path)
    del net
    twin_launches, twin = phase_twin(tmp, train_path, val_path, captured_img_s)
    gemm_launches = [matmul.launches, matmul_bn_stats.launches]
    log("  phase 14: GEMM kernel launches matmul/matmul_bn_stats {}".format(gemm_launches))
    return ((ckpt_launches, test_launches, twin_launches), gemm_launches,
            {"checkpoint": ckpt, "network_test": test, "script": twin})


# --------------------------------------------------------------------------- #
# Phases 15-17: CAM and Grad-CAM, MobileNet-V2, the MNIST script
# --------------------------------------------------------------------------- #
ALL_KERNELS = AUG_KERNELS + (matmul, matmul_bn_stats)
CAM_IMAGES = 16   # phase 15's batch
CAM_TWIN = 4      # the first CAM_TWIN of them also go through the CPU twin
CAM_TOP = 3
CAM_SCORE_TOL = 1e-5  # scores (softmax probs), absolute
CAM_MAP_TOL = 1e-3    # maps in [0, 1], absolute, where the CPU map is not all 0
# the flagship's depthwise layers up to a tap (res4: 2 a block), and its
# batch norms up to res8 (all 34 train-mode ones)
RES4_DW = 8
# the depthwise layers of phases 16 and 18 at 224 px: (H = W of the input, C,
# stride, how many); 3x3 ones take the hand kernels, 5x5 ones F.conv2d
MNV2_DW = [(112, 32, 1, 1), (112, 96, 2, 1), (56, 144, 1, 1), (56, 144, 2, 1),
           (28, 192, 1, 2), (28, 192, 2, 1), (14, 384, 1, 4), (14, 576, 1, 2),
           (14, 576, 2, 1), (7, 960, 1, 3)]
V3L_DW = [(112, 16, 1, 1), (112, 64, 2, 1), (56, 72, 1, 1), (28, 240, 2, 1), (14, 200, 1, 1),
          (14, 184, 1, 2), (14, 480, 1, 1), (14, 672, 1, 1)]
V3L_DW5 = [(56, 72, 2, 1), (28, 120, 1, 2), (14, 672, 2, 1), (7, 960, 1, 2)]
LITE0_DW = [(112, 32, 1, 1), (112, 96, 2, 1), (56, 144, 1, 1), (28, 240, 2, 1), (14, 480, 1, 2),
            (7, 1152, 1, 1)]
LITE0_DW5 = [(56, 144, 2, 1), (28, 240, 1, 1), (14, 480, 1, 1), (14, 672, 1, 2), (14, 672, 2, 1),
             (7, 1152, 1, 3)]
# the bias passes of MobileNet-V3-Large's BN-folded test forward at 224 px:
# (output shape without the batch axis, the act, how many); 48 a dispatch:
# none 16, relu 11, hswish 21
V3L_BIAS = [
    ((112, 112, 16), "hswish", 1), ((112, 112, 16), "relu", 1), ((112, 112, 16), "none", 1),
    ((112, 112, 64), "relu", 1), ((56, 56, 64), "relu", 1), ((56, 56, 24), "none", 2),
    ((56, 56, 72), "relu", 3), ((28, 28, 72), "relu", 1), ((28, 28, 40), "none", 3),
    ((28, 28, 120), "relu", 4), ((28, 28, 240), "hswish", 1), ((14, 14, 240), "hswish", 1),
    ((14, 14, 80), "none", 4), ((14, 14, 200), "hswish", 2), ((14, 14, 184), "hswish", 4),
    ((14, 14, 480), "hswish", 2), ((14, 14, 112), "none", 2), ((14, 14, 672), "hswish", 3),
    ((7, 7, 672), "hswish", 1), ((7, 7, 160), "none", 3), ((7, 7, 960), "hswish", 5),
    ((1280,), "hswish", 1), ((1000,), "none", 1),
]
MNV2_NUDGE = 1e-6  # the CPU twin's yardstick: its input scaled by 1 + this
# the twin's update, relative L2 over all parameters: a 1e-6 nudge of the
# input moves the CPU's own update by about 0.8% (relative L2 at 224 px,
# batch 4), the early layers' 0.01-scale weights taking most of it
MNV2_UPDATE_TOL = 5e-2


class Zoo:
    """A model of the stretch zoo as phases 16 and 18 drive it at full
    width: its class and constructor name, the seed of its served batch, its
    depthwise layers (``dw`` 3x3, ``dw5`` 5x5), its batch norms and, where
    the phases hold the served launches to a table, its folded forward's
    bias passes (``bias``, as ``V3L_BIAS``)."""

    def __init__(self, name, cls, tag, seed, dw, bn_layers, dw5=(), bias=None):
        self.name, self.cls, self.tag, self.seed = name, cls, tag, seed
        self.dw, self.dw5, self.bn_layers = list(dw), list(dw5), bn_layers
        self.bias = bias
        self.image, self.classes = (3, 224, 224), 1000
        self.lr = 0.05 * (BATCH / 200.0)

    @property
    def dw_layers(self):
        return sum(n for *_, n in self.dw)

    @property
    def want(self):
        """forward/dx/dw/bn_stats launches of one eager training step."""
        return [self.dw_layers] * 3 + [self.bn_layers]

    @property
    def replay(self):
        """(kernel name, count) of one replay of its captured step."""
        return (("depthwise3x3_fwd_vec_kernel", self.dw_layers),
                ("depthwise3x3_dx_vec_kernel", self.dw_layers),
                ("depthwise3x3_dw_vec_kernel", self.dw_layers),
                ("bn_stats_partial_kernel", self.bn_layers)) + tuple(
                    (n, 0) for n in GEMM_KERNELS + ("bias_act_kernel",))

    @property
    def bias_want(self):
        """bias_act's launches by act in one folded served dispatch."""
        out = dict.fromkeys(bias_act.launches_by_act, 0)
        for _, act, n in self.bias:
            out[act] += n
        return out

    def fresh(self):
        """The network from np.random.seed(0), on the CPU."""
        np.random.seed(0)
        return self.cls(self.tag, num_classes=self.classes)

    def pair(self):
        """The network on the CPU with the serving weights and calibrated
        statistics of utils/seeded.py, and its copy on the card."""
        net_cpu = self.fresh()
        seed_serving_weights(net_cpu, seed=0, calib_hw=self.image[1:])
        net_gpu = self.fresh()
        net_gpu.load_numpy_params(net_cpu.gather_params(), net_cpu.gather_states())
        return net_cpu, net_gpu.to(DEVICE)

    def batches(self, seed, steps, B):
        rng = np.random.RandomState(seed)
        X = rng.randn(steps, B, *self.image).astype(np.float32)
        y = np.eye(self.classes, dtype=np.float32)[rng.randint(0, self.classes, (steps, B))]
        return X, y


MNV2 = Zoo("MobileNet-V2", MobileNetV2, "mnv2", 16, MNV2_DW, 52)
V3L = Zoo("MobileNet-V3-Large", MobileNetV3Large, "mnv3l", 18, V3L_DW, 46, dw5=V3L_DW5,
          bias=V3L_BIAS)
LITE0 = Zoo("EfficientNet-Lite0", EfficientNetLite0, "enl0", 181, LITE0_DW, 49, dw5=LITE0_DW5)
RESNET50 = Zoo("ResNet-50", ResNet50, "resnet50", 182, [], 49)
MNIST_TWIN = "dorknet_tpu_torch.examples.MNIST_basic_convnet"
MNIST_BN_LAYERS = 5


def kernel_counts():
    """{kernel name: launches} of every kernel of the port."""
    return {k.__name__: k.launches for k in ALL_KERNELS + (bias_act,)}


def counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after (the card synchronised): (its result, {name: launches})."""
    torch.cuda.synchronize()
    reset_launches(ALL_KERNELS + (bias_act,))
    out = fn()
    torch.cuda.synchronize()
    return out, kernel_counts()


def bn_buffers(net):
    return [b.detach().clone() for m in net.modules() if isinstance(m, BatchNormLayer)
            for b in (m.running_mean, m.running_std)]


def cam_calls():
    """The CAM entry points phase 15 drives: name -> fn(net, X) -> (scores,
    maps) with a leading image axis."""
    def single(net, X):
        s, c = cam.compute_cam_scores(net, X[:1], top_k=CAM_TOP, out_size=IMAGE[1])
        return s[None], c[None]

    return {
        "cam_batch": lambda net, X: cam.compute_cam_scores_batch(
            net, X, top_k=CAM_TOP, terminal_layer_name="res8", out_size=IMAGE[1]),
        "gradcam_res8": lambda net, X: cam.compute_gradcam_scores_batch(
            net, X, top_k=CAM_TOP, terminal_layer_name="res8", out_size=IMAGE[1]),
        "gradcam_res4": lambda net, X: cam.compute_gradcam_scores_batch(
            net, X, top_k=CAM_TOP, terminal_layer_name="res4", out_size=IMAGE[1]),
        "cam_single": single,
    }


def cam_want(name, n):
    """Launches forward/dx/dw/bn_stats of one call over n images: a test-mode
    forward (16 depthwise) for the scores, then CAM's train-mode tap of each
    image to res8 (16 depthwise, 34 batch norms), or Grad-CAM's backward
    from the logits to the tap, k times (8 depthwise dx from res4, none from
    res8), and no dw."""
    return {"cam_batch": [DW_LAYERS * (1 + n), 0, 0, BN_LAYERS * n],
            "gradcam_res8": [DW_LAYERS, 0, 0, 0],
            "gradcam_res4": [DW_LAYERS, RES4_DW * CAM_TOP, 0, 0],
            "cam_single": [2 * DW_LAYERS, 0, 0, BN_LAYERS]}[name]


def phase_cam(net_cpu, net_gpu, tmp):
    """Phase 15. Returns {call: {kernel: launches}} and the numbers."""
    log("== phase 15: CAM and Grad-CAM on the flagship ({} px, {} classes, seeded weights, "
        "calibrated statistics), {} images, top {}".format(IMAGE[1], NUM_CLASSES, CAM_IMAGES,
                                                          CAM_TOP))
    log("card:", card_line())
    X = np.random.RandomState(15).randn(CAM_IMAGES, *IMAGE).astype(np.float32)
    xg = torch.from_numpy(X).to(DEVICE)
    stats = bn_buffers(net_gpu)
    launches, numbers = {}, {}
    for name, fn in cam_calls().items():
        n = 1 if name == "cam_single" else CAM_IMAGES
        (scores, maps), counts = counted(lambda: fn(net_gpu, xg))
        launches[name] = counts
        got = [counts[k.__name__] for k in TRAIN_KERNELS]
        want = cam_want(name, n)
        log("  {}: launches forward/dx/dw/bn_stats {} (want {})".format(name, got, want))
        require(got == want, "{}: a layer missed its kernel, or a weight gradient ran".format(
            name))
        require_vector_route(name, kernels=(depthwise3x3,) + ((depthwise3x3_dx,)
                                                             if got[1] else ()))
        require(tuple(maps.shape) == (n, CAM_TOP, IMAGE[1], IMAGE[2]),
                "{}: maps shape {}".format(name, tuple(maps.shape)))
        require(bool(torch.isfinite(maps).all()) and float(maps.min()) >= 0.0
                and float(maps.max()) <= 1.0 + 1e-6, "{}: maps outside [0, 1]".format(name))
        # the CPU twin on the first images (each image's result depends on it alone)
        k = min(n, CAM_TWIN)
        s_cpu, m_cpu = fn(net_cpu, X[:k])
        s_err = float((scores[:k].cpu() - s_cpu).abs().max())
        live = m_cpu.amax(dim=(2, 3)) > 0  # maps the ReLU left something of
        require(bool(live.any()), "{}: every CPU map is 0".format(name))
        m_err = float((maps[:k].cpu() - m_cpu).abs().amax(dim=(2, 3))[live].max())
        log("    vs the CPU twin on {} images: max|dscore| {:.3e} (limit {:.0e}), max|dmap| "
            "{:.3e} over {} of {} maps (limit {:.0e}; the rest are 0 on the CPU: {})".format(
                k, s_err, CAM_SCORE_TOL, m_err, int(live.sum()), live.numel(), CAM_MAP_TOL,
                bool((maps[:k].cpu()[~live] == 0).all())))
        require(s_err <= CAM_SCORE_TOL, "{}: scores differ from the CPU twin's".format(name))
        require(m_err <= CAM_MAP_TOL, "{}: maps differ from the CPU twin's".format(name))
        # CAM over 16 images queues some 3,000 kernels, more than the card
        # takes pending behind device_ms's spin: its device ms is the
        # profiler's busy time
        events = measure_device_ms(lambda: fn(net_gpu, xg), runs=10, warmup=2)
        span, by_class, _, n_kernels = device_profile(lambda: fn(net_gpu, xg), steps=2)
        busy = sum(by_class.values())
        numbers[name] = dict(images=n, events_ms=events, busy_ms=busy, kernels=n_kernels,
                             idle_share=max(0.0, 1.0 - busy / span) if busy else None,
                             img_s=n / events * 1e3, max_abs_score_err=s_err,
                             max_abs_map_err=m_err)
        log("    events {:.3f} ms = {:.1f} img/s; profiler: {} kernels, busy {:.3f} ms of "
            "{:.3f} ms (host clock with the profiler on); by class {}".format(
                events, n / events * 1e3, n_kernels, busy, span,
                {c: round(v, 3) for c, v in sorted(by_class.items(), key=lambda kv: -kv[1])}))
    moved = [i for i, (a, b) in enumerate(zip(stats, bn_buffers(net_gpu))) if not torch.equal(a, b)]
    log("  running stats: {} tensors, {} moved".format(len(stats), len(moved)))
    require(not moved, "CAM moved a running statistic")
    require(all(p.requires_grad and p.grad is None for p in net_gpu.parameters()),
            "Grad-CAM left a weight gradient or a cleared requires_grad")
    out_dir = os.path.join(tmp, "cam_demo")
    t0 = time.perf_counter()
    (correct, demo_launches) = counted(lambda: synthetic_cam_demo.main(out_dir))
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    log("  synthetic CAM demo on the card: {:.1f} s, {} PNGs {}, launches {}".format(
        time.perf_counter() - t0, len(pngs), pngs, demo_launches))
    require(len(pngs) == 4 and 0 <= correct <= 4, "the CAM demo's PNGs")
    numbers["demo"] = dict(correct=correct, pngs=pngs, launches=demo_launches)
    return launches, numbers


def phase_zoo_serving(z, label, runs=("unfolded", "folded"), timed=True):
    """Phase 16a / 18a (both runs, timed) and 18e (folded only). Returns the
    launches of each served run and the numbers."""
    log("== phase {}: {} served ({} px, {} classes, batch {}; seeded weights, calibrated "
        "statistics), {}".format(label, z.name, z.image[1], z.classes, BATCH,
                                 " and ".join(r if r == "unfolded" else "BN-folded"
                                              for r in runs)))
    log("card:", card_line())
    net_cpu, net_gpu = z.pair()
    X = np.random.RandomState(z.seed).randn(BATCH, *z.image).astype(np.float32)
    runners = {r: InferenceRunner(net_gpu, batch_size=BATCH, device=DEVICE,
                                  fold_bn=r == "folded") for r in runs}
    want = [z.dw_layers, 0, 0, 0]
    launches, probs, bias_by_act = {}, {}, {}
    for name, runner in runners.items():
        sequence.run_layers.fused_bias = dict.fromkeys(bias_act.launches_by_act, 0)
        probs[name], launches[name] = counted(lambda: runner.predict_probs(X))
        got = [launches[name][k.__name__] for k in TRAIN_KERNELS]
        by_act = dict(bias_act.launches_by_act)
        log("  {}: launches forward/dx/dw/bn_stats {} (want {}); bias_act by act {}".format(
            name, got, want, by_act))
        require(got == want, "{} {}: a layer missed its kernel".format(z.name, name))
        require(by_act == sequence.run_layers.fused_bias,
                "{} {}: a biased layer missed its bias pass".format(z.name, name))
        if z.bias and name == "folded":
            require(by_act == z.bias_want, "{} {}: bias passes {}, want {}".format(
                z.name, name, by_act, z.bias_want))
        bias_by_act[name] = by_act
        if z.dw_layers:
            require_vector_route("{} {}".format(z.name, name))
        require(probs[name].shape == (BATCH, z.classes) and np.isfinite(probs[name]).all(),
                "{}: probs".format(name))
    _, want_probs = net_cpu.forward(X[:2], test_mode=True)
    err = {name: float(np.abs(p[:2] - want_probs.numpy()).max()) for name, p in probs.items()}
    if len(runs) == 2:
        err["folded_vs_unfolded"] = float(np.abs(probs["folded"] - probs["unfolded"]).max())
    log("  max|dprob|: vs the CPU forward on 2 images {} (limit 1e-4){}; max prob of the first "
        "4 {}".format({k: "{:.3e}".format(v) for k, v in err.items() if k in runs},
                      ", folded vs unfolded on {} images {:.3e} (limit 1e-4)".format(
                          BATCH, err["folded_vs_unfolded"]) if len(runs) == 2 else "",
                      [round(float(p), 4) for p in probs[runs[0]][:4].max(1)]))
    require(max(err.values()) <= 1e-4, "{} serving disagrees".format(z.name))
    numbers = dict(max_abs_prob_err=err, bias_act_by_act=bias_by_act)
    if not timed:
        return launches, numbers
    x = torch.from_numpy(X).to(DEVICE)
    with torch.inference_mode():
        times = forward_times({k: r.network._test_fn for k, r in runners.items()}, x)
    for k, t in times.items():
        log("  {} forward, batch {}: events {:.3f} ms = {:.0f} img/s, device {:.3f} ms; {} "
            "kernels, busy {:.3f} ms, idle {:.1%}, depthwise forward {:.3f} ms{}, elementwise "
            "{:.3f} ms, GEMM {:.3f} ms".format(
                k, BATCH, t["events"], BATCH / t["events"] * 1e3, t["device"], t["kernels"],
                t["busy"], t["idle"], t["dw_forward"],
                ", 5x5 depthwise (cuDNN) {:.3f} ms".format(t["dw5"]) if z.dw5 else "",
                t["elementwise"], t["gemm"]))
    numbers["times"] = times
    return launches, numbers


def phase_zoo_train(z, label, twin=True):
    """Phase 16b / 18b, and 18e's eager step (``twin=False``). Returns the
    eager step's launches and its numbers."""
    log("== phase {}: {} trained by Trainer.step (eager, batch {}, fresh network from "
        "np.random.seed(0), SGDMomentum)".format(label, z.name, BATCH))
    net = z.fresh()
    trainer = Trainer(net, SGDMomentum(net, z.lr, 0.9), device=DEVICE, cuda_graph=False)
    X, y = z.batches(z.seed, 1, BATCH)
    (loss, preds), counts = counted(lambda: trainer.step(X[0], y[0]))
    got = [counts[k.__name__] for k in TRAIN_KERNELS]
    log("  step: loss {:.6f}, launches forward/dx/dw/bn_stats {} (want {})".format(
        float(loss), got, z.want))
    require(got == z.want, "{}: a layer missed its kernel".format(z.name))
    require(counts["bias_act"] == 0, "{}: a training step launched bias_act".format(z.name))
    if z.dw_layers:
        require_vector_route("{} step".format(z.name), kernels=KERNELS)
    require(np.isfinite(float(loss)), "non-finite loss")
    del trainer, net
    if not twin:
        return counts, dict(loss=float(loss))
    # the CPU twin: one step at batch 4 from the same fresh weights. The
    # flagship's per-parameter limit (1e-4 relative + 1e-5 absolute) cannot
    # hold here: the fresh 0.01-scale weights under some 50 batch norms
    # amplify rounding, so the CPU alone, its input scaled by 1 + MNV2_NUDGE,
    # moves the early layers' weights far past that limit (logged beside the
    # card's). The gate is the loss and the update as a whole (its relative L2
    # difference over all parameters); each kernel is held to its plain
    # version at every shape of the model in 16d / 18d.
    Xt, yt = z.batches(z.seed + 1, 1, 4)
    start = z.fresh()
    names = [n for n, _ in start.named_parameters()]
    start = [p.detach() for p in start.parameters()]
    runs = []
    for device, scale in ((DEVICE, 1.0), ("cpu", 1.0), ("cpu", 1.0 + MNV2_NUDGE)):
        net = z.fresh()
        t = Trainer(net, SGDMomentum(net, 0.05 * 4 / 200.0, 0.9), device=device,
                    cuda_graph=False)
        loss_t = float(t.step(Xt[0] * np.float32(scale), yt[0])[0])
        runs.append((loss_t, [p.detach().cpu() for p in net.parameters()]))
    (got, card), (want, cpu), (_, nudged) = runs

    def spread(a, b):
        """The update's relative L2 difference over all parameters, and
        the tensors furthest outside the flagship's per-element limit."""
        diff = sum(float(((p - q) ** 2).sum()) for p, q in zip(a, b))
        norm = sum(float(((q - s) ** 2).sum()) for q, s in zip(b, start))
        shares = sorted(((float(((p - q).abs() / (1e-5 + 1e-4 * q.abs())).max()), n)
                         for p, q, n in zip(a, b, names)), reverse=True)
        return (diff / norm) ** 0.5, shares[:3]

    rel = abs(got - want) / abs(want)
    (card_l2, card_top), (cpu_l2, cpu_top) = spread(card, cpu), spread(nudged, cpu)
    log("  CPU twin, one step at batch 4: loss card {:.7f}, CPU {:.7f}, relative difference "
        "{:.3e} (limit 1e-4); the update's relative L2 difference card vs CPU {:.3e} (limit "
        "{:.0e}), the CPU's own with its input scaled by 1 + {:.0e} {:.3e}; shares of the "
        "flagship's per-element limit, largest: card {}, nudged CPU {}".format(
            got, want, rel, card_l2, MNV2_UPDATE_TOL, MNV2_NUDGE, cpu_l2,
            [(round(s, 2), n) for s, n in card_top], [(round(s, 2), n) for s, n in cpu_top]))
    require(rel <= 1e-4, "{}: card and CPU losses disagree".format(z.name))
    require(card_l2 <= MNV2_UPDATE_TOL, "{}: card and CPU updates disagree".format(z.name))
    return counts, dict(loss=float(loss), twin_loss_rel=rel, twin_update_rel_l2=card_l2,
                        cpu_nudged_update_rel_l2=cpu_l2, twin_param_of_limit=card_top[0][0],
                        cpu_nudged_param_of_limit=cpu_top[0][0])


def peak_mb(trainer, x, y):
    """A step's peak memory over what was allocated before it, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss, _ = trainer.step(x, y)
    torch.cuda.synchronize()
    require(np.isfinite(float(loss)), "non-finite loss")
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_zoo_captured(z, label, full=True):
    """Phase 16c / 18c (``full``: the replay's kernels by name, eager and
    captured in turns, memory) and 18e (the captured step's time). Returns
    the captured trainer's own launches, one replay's kernels by name ({}
    unless ``full``) and the numbers."""
    log("== phase {}: {} captured steps{} (batch {})".format(
        label, z.name, " against eager ones" if full else "", BATCH))
    pair = graph_pair(make=z.fresh, lr=z.lr, flags=(True, False) if full else (True,))
    X, y = z.batches(z.seed + 2, 1, BATCH)
    x, yy = torch.from_numpy(X[0]).to(DEVICE), torch.from_numpy(y[0]).to(DEVICE)
    captured = pair[0]
    # adoption, warm-up and capture: three eager steps' launches, then replays
    _, run = counted(lambda: [captured.step(x, yy) for _ in range(4)])
    log("  the captured trainer's first 4 calls: launches {}".format(run))
    require([run[k.__name__] for k in TRAIN_KERNELS] == [3 * n for n in z.want]
            and run["bias_act"] == 0, "the captured trainer's eager steps")
    pool = pool_bytes(captured._pool) / 1e6
    if not full:
        ms = measure_device_ms(lambda: captured.step(x, yy), runs=10, warmup=2)
        log("  captured step: {:.3f} ms = {:.0f} img/s; graph pool {:.1f} MB; capture {:.3f} "
            "s".format(ms, BATCH / ms * 1e3, pool, captured.capture_seconds))
        return run, {}, dict(captured_ms=ms, pool_mb=pool,
                             capture_seconds=captured.capture_seconds)
    replay = require_replay_kernels("{} Trainer.step".format(z.name),
                                    lambda: captured.step(x, yy), z.replay)
    times = step_times(pair, lambda t: t.step(x, yy), "{} Trainer.step".format(z.name), BATCH)
    peak = {which: peak_mb(t, x, yy) for which, t in zip(("captured", "eager"), pair)}
    log("  a step's peak memory over the allocated before it: captured {:.1f} MB, eager "
        "{:.1f} MB; graph pool {:.1f} MB; capture {:.3f} s".format(
            peak["captured"], peak["eager"], pool, captured.capture_seconds))
    return run, replay, dict(times=times, peak_mb=peak, pool_mb=pool,
                             capture_seconds=captured.capture_seconds)


def phase_zoo_shapes(z, label):
    """Phase 16d / 18d: the depthwise forward, dx and dw at each of the
    model's 3x3 shapes at batch 64, fp32, device time against cuDNN (TF32
    off) and the bound; then its 5x5 layers under cuDNN, forward and
    backward, for the record. Returns a list of rows and the totals."""
    log("== phase {}: depthwise kernels at {}'s shapes, batch {}, fp32, device ms (calls "
        "behind a spin kernel) against cuDNN (F.conv2d(groups=C) and its backward, TF32 off) "
        "and the bound".format(label, z.name, BATCH))
    log("card:", card_line())
    require(not torch.backends.cudnn.allow_tf32, "cuDNN's yardstick would run in TF32")
    rows, totals = [], {}
    seed = 100 * int(label[:2])
    for i, (H, C, stride, n) in enumerate(z.dw):
        x, w = dw_inputs(BATCH, H, C, torch.float32, seed=seed + i)
        g = grad_input(BATCH, H, C, stride, torch.float32, seed=seed + 100 + i)
        xc, wc = x.permute(0, 3, 1, 2), w.unsqueeze(1)
        calls = {
            "fwd": lambda: depthwise3x3(x, w, stride),
            "fwd_cudnn": lambda: F.conv2d(xc, wc, stride=stride, padding=1, groups=C),
            "dx": lambda: depthwise3x3_dx(g, w, stride, H, H),
            "dx_cudnn": lambda: cudnn_grad(g, x, w, stride, [True, False, False]),
            "dw": lambda: depthwise3x3_dw(x, g, stride),
            "dw_cudnn": lambda: cudnn_grad(g, x, w, stride, [False, True, False]),
        }
        with torch.inference_mode():
            ms = {k: device_ms([fn]) for k, fn in calls.items()}
            # each kernel against its plain version at this shape (phase 2's
            # and phase 6's limits)
            errs = {}
            for k, got, ref, limit in (
                    ("fwd", calls["fwd"](), depthwise3x3_plain(x, w, stride), None),
                    ("dx", calls["dx"](), depthwise3x3_dx_plain(g, w, stride, H, H), None),
                    ("dw", calls["dw"](), depthwise3x3_dw_plain(x, g, stride),
                     2e-5 * depthwise3x3_dw_plain(x.abs(), g.abs(), stride) + 1e-6)):
                if limit is None:
                    limit = 1e-5 * ref.abs().max() + 1e-6
                errs[k] = ((got - ref).abs() / limit).max().item()
        log("    vs the plain versions, the largest share of the limit: {}".format(
            {k: round(v, 4) for k, v in errs.items()}))
        require(all(v <= 1.0 for v in errs.values()),
                "a depthwise kernel disagrees with its plain version at {}'s {}x{}x{} s{}".format(
                    z.name, H, H, C, stride))
        bound, by = dw_bound_ms(BATCH, H, C, stride)
        dw_bound, dw_by = dw_bound_ms(BATCH, H, C, stride, 9 * C * 4)
        row = dict(N=BATCH, H=H, C=C, stride=stride, layers=n, bound_ms=bound, bound_by=by,
                   dw_bound_ms=dw_bound, share_of_limit=errs, **ms)
        row["loses_to_cudnn"] = [k for k in ("fwd", "dx", "dw") if ms[k] > ms[k + "_cudnn"]]
        rows.append(row)
        for k in calls:
            totals[k] = totals.get(k, 0.0) + n * ms[k]
        log("  {}x{}x{} s{} (x{}): fwd {:.4f} / cuDNN {:.4f}, dx {:.4f} / {:.4f}, dw {:.4f} / "
            "{:.4f} ms; bound {:.4f} ({}), dw {:.4f}; loses to cuDNN: {}".format(
                H, H, C, stride, n, ms["fwd"], ms["fwd_cudnn"], ms["dx"], ms["dx_cudnn"],
                ms["dw"], ms["dw_cudnn"], bound, by, dw_bound, row["loses_to_cudnn"] or "none"))
    bound = sum(n * dw_bound_ms(BATCH, H, C, s)[0] for H, C, s, n in z.dw)
    dw_bound = sum(n * dw_bound_ms(BATCH, H, C, s, 9 * C * 4)[0] for H, C, s, n in z.dw)
    lost = sum(len(r["loses_to_cudnn"]) * r["layers"] for r in rows)
    log("  over the {} layers: {}; bound {:.4f} ms (dw {:.4f}): forward {:.1%}, dx {:.1%}, dw "
        "{:.1%} of it; (kernel, layer) pairs that lose to cuDNN: {} of {}".format(
            z.dw_layers, {k: round(v, 4) for k, v in totals.items()}, bound, dw_bound,
            bound / totals["fwd"], bound / totals["dx"], dw_bound / totals["dw"], lost,
            3 * z.dw_layers))
    totals = dict(totals, bound_ms=bound, dw_bound_ms=dw_bound, losing_pairs=lost)
    if z.dw5:
        totals["dw5"] = conv5_times(z, seed + 200)
    return rows, totals


def conv5_times(z, seed):
    """The 5x5 depthwise layers under cuDNN (F.conv2d(groups=C), padding 2,
    and its backward for dx and dw together), device ms, for the record."""
    rows, total = [], {"fwd": 0.0, "bwd": 0.0}
    for i, (H, C, stride, n) in enumerate(z.dw5):
        gen = torch.Generator(device=DEVICE).manual_seed(seed + i)
        x = torch.randn(BATCH, H, H, C, generator=gen, device=DEVICE)
        w = torch.randn(C, 5, 5, generator=gen, device=DEVICE)
        g = grad_input(BATCH, H, C, stride, torch.float32, seed=seed + 50 + i)
        xc, wc = x.permute(0, 3, 1, 2), w.unsqueeze(1)
        with torch.inference_mode():
            ms = {"fwd": device_ms([lambda: F.conv2d(xc, wc, stride=stride, padding=2,
                                                     groups=C)]),
                  "bwd": device_ms([lambda: cudnn_grad(g, x, w, stride, [True, True, False],
                                                       padding=2)])}
        rows.append(dict(H=H, C=C, stride=stride, layers=n, **ms))
        for k in total:
            total[k] += n * ms[k]
    log("  the {} 5x5 layers under cuDNN: {}; forward {:.4f} ms, backward (dx and dw) {:.4f} "
        "ms over the layers".format(sum(n for *_, n in z.dw5),
                                    [(r["H"], r["C"], r["stride"], round(r["fwd"], 4),
                                      round(r["bwd"], 4)) for r in rows],
                                    total["fwd"], total["bwd"]))
    return dict(rows=rows, **total)


def phase_zoo(z, phase):
    """Phase 16 / 18a-18d. Returns {run: {kernel: launches}}, the replay's
    kernels and the numbers."""
    serve_launches, serving = phase_zoo_serving(z, phase + "a")
    step_launches, train = phase_zoo_train(z, phase + "b")
    run, replay, captured = phase_zoo_captured(z, phase + "c")
    rows, totals = phase_zoo_shapes(z, phase + "d")
    torch.cuda.empty_cache()
    launches = dict(serving_unfolded=serve_launches["unfolded"],
                    serving_folded=serve_launches["folded"], eager_step=step_launches,
                    captured_run=run)
    return launches, replay, dict(serving=serving, train=train, captured=captured,
                                  shapes=rows, shape_totals=totals)


def phase_deep_zoo():
    """Phase 18e: EfficientNet-Lite0 and ResNet-50 served BN-folded, one
    eager step and the captured step's time each. Returns {run: {kernel:
    launches}} and the numbers."""
    launches, numbers = {}, {}
    for z in (LITE0, RESNET50):
        tag = z.tag
        serve, serving = phase_zoo_serving(z, "18e", runs=("folded",), timed=False)
        step, train = phase_zoo_train(z, "18e", twin=False)
        run, _, captured = phase_zoo_captured(z, "18e", full=False)
        torch.cuda.empty_cache()
        launches.update({tag + "_serving_folded": serve["folded"], tag + "_eager_step": step,
                         tag + "_captured_run": run})
        numbers[tag] = dict(serving=serving, train=train, captured=captured)
    return launches, numbers


def write_mnist(path, n_train=2000, n_test=1000):
    """Synthetic digits in scripts/MNISTprepper.py's layout (images (N, 784)
    uint8, labels (N,) uint8), with a class signal in the intensity."""
    rng = np.random.RandomState(17)
    os.makedirs(path)
    for split, n in (("Train", n_train), ("Test", n_test)):
        y = rng.randint(0, 10, n).astype(np.uint8)
        x = rng.randint(0, 64, (n, 784)) + 19 * y[:, None]
        np.save(os.path.join(path, "MNIST{}Images.npy".format(split)), x.astype(np.uint8))
        np.save(os.path.join(path, "MNIST{}Labels.npy".format(split)), y)


def phase_mnist(tmp):
    """Phase 17: the MNIST twin's __main__ on the card, one short epoch.
    Returns its launches and its metrics line."""
    log("== phase 17: the MNIST script (MNISTNet, batch 200, one epoch of 10 steps) on "
        "synthetic npy files")
    path = os.path.join(tmp, "MNIST_data")
    write_mnist(path)
    env = {"DORKNET_MNIST_DIR": path, "DORKNET_EPOCHS": "1", "DORKNET_NUM_TRAIN": "2000",
           "DORKNET_NUM_VAL": "0", "DORKNET_NUM_TEST": "1000",
           "DORKNET_METRICS": os.path.join(tmp, "mnist_metrics.jsonl")}
    t0 = time.perf_counter()
    _, launches = counted(lambda: run_twin(env, MNIST_TWIN))
    seconds = time.perf_counter() - t0
    record = read_metrics(env["DORKNET_METRICS"])[-1]
    log("  {:.1f} s".format(seconds))
    log("  metrics: {}; launches {} (MNISTNet runs no depthwise layer: batch_norm_stats only, "
        "{} a step in the trainer's three eager steps, none in its replays or the test)".format(
            {k: record[k] for k in ("epoch", "loss", "test_acc", "train_img_s")}, launches,
            MNIST_BN_LAYERS))
    require(np.isfinite(record["loss"]) and 0.0 <= record["test_acc"] <= 1.0,
            "the MNIST script's metrics")
    require(launches["batch_norm_stats"] == 3 * MNIST_BN_LAYERS
            and launches["depthwise3x3"] == 0, "the MNIST script's launches")
    return launches, dict(seconds=seconds, **{k: record[k] for k in ("loss", "test_acc",
                                                                       "train_img_s")})


# ---- phase 19: the train-mode batch norm's normalise and backward ----------
BN_EPS = 1e-5
BN_TRAIN = (bn_apply, bn_bwd_reduce, bn_bwd_dx)
# activation-sized reads and writes of each kernel: x, y; dy, x; dy, x, dx
BN_PASSES = dict(bn_apply=2, bn_bwd_reduce=2, bn_bwd_dx=3)
BN_SUM_RTOL = 2e-5  # of the sum of the terms' magnitudes, for dbeta and dgamma
# kernels by name in one replay, each once a train-mode batch norm
BN_REPLAY = ("bn_stats_partial_kernel", "bn_apply_kernel", "bn_bwd_reduce_kernel",
             "bn_bwd_finish_kernel", "bn_bwd_dx_kernel")


def bn_shapes(make, image):
    """{shape without the batch axis: how many} of a model's train-mode
    batch-norm inputs, from one train-mode forward of one image on the CPU."""
    seen = []
    stats = norm_mod.batch_norm_stats

    def recording(x):
        seen.append(tuple(x.shape[1:]))
        return stats(x)

    net = make()
    x = torch.from_numpy(np.random.RandomState(2).randn(1, *image[1:], image[0])
                         .astype(np.float32))
    norm_mod.batch_norm_stats = recording
    try:
        with torch.no_grad():
            net._train_forward(x)
    finally:
        norm_mod.batch_norm_stats = stats
    out = {}
    for shape in seen:
        out[shape] = out.get(shape, 0) + 1
    return out


def eager_bn_tail(x, mean, var, gamma, beta, gy):
    """The eager ops the three kernels replace: the port's ``_BNCore`` after
    its statistics, forward and backward, as it was before them."""
    inv = torch.rsqrt(var + BN_EPS)
    x_hat = (x.float() - mean) * inv
    y = (gamma * x_hat + beta).to(x.dtype)
    saved = x_hat.to(x.dtype)
    dims = tuple(range(gy.dim() - 1))
    n = gy.numel() // gy.shape[-1]
    gyf, xh = gy.float(), saved.float()
    dbeta = gyf.sum(dim=dims)
    dgamma = (gyf * xh).sum(dim=dims)
    dx = (gamma * inv) * (gyf - dbeta / n - xh * (dgamma / n))
    return y, dx.to(gy.dtype), dgamma, dbeta


def bn_train_inputs(shape, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = (torch.randn(*shape, generator=g, device=DEVICE) * 1.5 + 0.25).to(dtype)
    gy = torch.randn(*shape, generator=g, device=DEVICE).to(dtype)
    C = shape[-1]
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device=DEVICE)
    beta = 0.1 * torch.randn(C, generator=g, device=DEVICE)
    mean, var = batch_norm_stats(x)
    return x, gy, mean, var, gamma, beta


def bn_train_check(shape, dtype, seed):
    """The three kernels at one shape against their plain versions: y,
    (mean, inv) and dx (from the kernel's factors) bit-equal; dbeta and
    dgamma within BN_SUM_RTOL of fp64 sums of the same terms; two runs
    bit-equal. Returns the sums' worst share of their limit."""
    x, gy, mean, var, gamma, beta = bn_train_inputs(shape, dtype, seed)
    (y, norm), (y2, norm2) = (bn_apply(x, mean, var, gamma, beta, BN_EPS) for _ in range(2))
    y_ref, norm_ref = bn_apply_plain(x, mean, var, gamma, beta, BN_EPS)
    (dgamma, dbeta, coef), again = (bn_bwd_reduce(gy, x, norm, gamma) for _ in range(2))
    dx, dx2 = (bn_bwd_dx(gy, x, norm, coef) for _ in range(2))
    same = (torch.equal(y, y_ref) and torch.equal(norm, norm_ref)
            and torch.equal(dx, bn_bwd_dx_plain(gy, x, norm, coef)))
    repeat = (torch.equal(y, y2) and torch.equal(norm, norm2) and torch.equal(dx, dx2)
              and all(torch.equal(a, b) for a, b in zip((dgamma, dbeta, coef), again)))
    C = shape[-1]
    g64 = gy.double().reshape(-1, C)
    t64 = g64 * ((x.float() - norm[0]) * norm[1]).to(dtype).double().reshape(-1, C)
    share = max(float(((dbeta.double() - g64.sum(0)).abs()
                       / (BN_SUM_RTOL * g64.abs().sum(0) + 1e-30)).max()),
                float(((dgamma.double() - t64.sum(0)).abs()
                       / (BN_SUM_RTOL * t64.abs().sum(0) + 1e-30)).max()))
    count = torch.full_like(dbeta, float(g64.shape[0]))
    factors = torch.equal(coef, torch.stack([gamma * norm[1], dbeta / count, dgamma / count]))
    torch.cuda.synchronize()
    require(same and factors, "{} {}: a batch-norm kernel disagrees with its plain "
            "version".format(shape, dtype))
    require(repeat, "{} {}: two batch-norm kernel runs differ".format(shape, dtype))
    require(share <= 1.0, "{} {}: bn_bwd_reduce's sums are off".format(shape, dtype))
    return share


def bn_train_times(cell, shapes, batch):
    """Device ms of the cell's batch norms at its trained batch in fp32, one
    input a layer: each kernel alone over every layer, the three together
    and the eager ops they replace (in turns: eager, kernels, kernels,
    eager), against the bound of their activation passes at 3.35 TB/s."""
    layers, elems = [], 0
    for i, (shape, n) in enumerate(shapes.items()):
        for j in range(n):
            layers.append(bn_train_inputs((batch,) + shape, torch.float32, 1900 + 50 * i + j))
            elems += layers[-1][0].numel()
    saved = [bn_apply(x, mean, var, gamma, beta, BN_EPS)[1] for x, _, mean, var, gamma, beta
             in layers]
    coefs = [bn_bwd_reduce(gy, x, norm, gamma)[2]
             for (x, gy, _, _, gamma, _), norm in zip(layers, saved)]
    alone = dict(
        bn_apply=[lambda a=a: bn_apply(a[0], a[2], a[3], a[4], a[5], BN_EPS) for a in layers],
        bn_bwd_reduce=[lambda a=a, s=s: bn_bwd_reduce(a[1], a[0], s, a[4])
                       for a, s in zip(layers, saved)],
        bn_bwd_dx=[lambda a=a, s=s, c=c: bn_bwd_dx(a[1], a[0], s, c)
                   for a, s, c in zip(layers, saved, coefs)])

    def kernels(a):
        y, norm = bn_apply(a[0], a[2], a[3], a[4], a[5], BN_EPS)
        _, _, coef = bn_bwd_reduce(a[1], a[0], norm, a[4])
        return y, bn_bwd_dx(a[1], a[0], norm, coef)

    tails = dict(kernels=[lambda a=a: kernels(a) for a in layers],
                 eager=[lambda a=a: eager_bn_tail(a[0], a[2], a[3], a[4], a[5], a[1])
                        for a in layers])
    ms = {k: device_ms(calls, inner=1) for k, calls in alone.items()}
    turns = [device_ms(tails[k], inner=1) for k in ("eager", "kernels", "kernels", "eager")]
    pass_ms = elems * 4 / HBM_BYTES_PER_S * 1e3
    out = dict(layers=len(layers), gb_a_pass=elems * 4 / 1e9,
               eager_device_ms=[turns[0], turns[3]], device_ms=[turns[1], turns[2]],
               bound_ms=7 * pass_ms)
    for k, t in ms.items():
        out[k] = dict(device_ms=t, bound_ms=BN_PASSES[k] * pass_ms,
                      share=BN_PASSES[k] * pass_ms / t)
        log("  {}: {} alone over the {} batch norms {:.4f} ms, bound {:.4f} ms ({} passes of "
            "{:.3f} GB at 3.35 TB/s): {:.1%}".format(cell, k, len(layers), t,
                                                      BN_PASSES[k] * pass_ms, BN_PASSES[k],
                                                      out["gb_a_pass"], out[k]["share"]))
    log("  {}: the three kernels together {:.4f} / {:.4f} ms ({:.1%} of the 7-pass bound "
        "{:.4f} ms); the eager ops they replace {:.4f} / {:.4f} ms (in turns: eager, kernels, "
        "kernels, eager)".format(cell, turns[1], turns[2], out["bound_ms"] / min(turns[1:3]),
                                 out["bound_ms"], turns[0], turns[3]))
    del layers, saved, coefs, alone, tails
    torch.cuda.empty_cache()
    return out


def bn_train_launches(make, classes, bns):
    """An eager Trainer.step of 2 images of 64 px: each wrapper's launches;
    then one replay of the captured step: the kernels by name."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32)).to(DEVICE)
    y = torch.from_numpy(np.eye(classes, dtype=np.float32)[[1, 2]]).to(DEVICE)
    net = make()
    eager = Trainer(net, SGDMomentum(net, 0.01, 0.9), device=DEVICE, cuda_graph=False)
    eager.step(x, y)  # adoption
    torch.cuda.synchronize()
    reset_launches(BN_TRAIN)
    eager.step(x, y)
    torch.cuda.synchronize()
    step = {k.__name__: k.launches for k in BN_TRAIN}
    net = make()
    captured = Trainer(net, SGDMomentum(net, 0.01, 0.9), device=DEVICE)
    for _ in range(3):  # adoption, warm-up and capture, a replay
        captured.step(x, y)
    replay, _, _, _ = replay_profile(lambda: captured.step(x, y), BN_REPLAY)
    require(step == dict.fromkeys(step, bns) and replay == dict.fromkeys(BN_REPLAY, bns)
            and captured.captures == 1, "a batch norm missed a kernel")
    return step, replay


def phase_bn_train():
    """Phase 19. Returns the kernels' entries of the kernels line."""
    log("== phase 19: train-mode batch norm after its statistics: bn_apply, bn_bwd_reduce, "
        "bn_bwd_dx at the benchmark cells' shapes")
    log("card:", card_line())
    cells = (("resnet18dw", fresh_resnet18, IMAGE, 2 * AUG_BATCH, NUM_CLASSES),
             ("mnv3l", V3L.fresh, V3L.image, 128, V3L.classes))
    entries = {k.__name__: dict(name=k.__name__, route="cuda",
                                source="dorknet_tpu_torch/csrc/bn_train.cu", replaces=None)
               for k in BN_TRAIN}
    for cell, make, image, batch, classes in cells:
        shapes = bn_shapes(make, image)
        bns = sum(shapes.values())
        worst = 0.0
        for i, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                worst = max(worst, bn_train_check((batch,) + shape, dtype, 1800 + i))
        log("  {}: {} batch norms, {} shapes at batch {}, fp32 and bf16: y, (mean, inv) and "
            "dx bit-equal to the plain versions, two runs bit-equal, the sums at most {:.3f} "
            "of their limit".format(cell, bns, len(shapes), batch, worst))
        torch.cuda.empty_cache()
        times = bn_train_times(cell, shapes, batch)
        step, replay = bn_train_launches(make, classes, bns)
        log("  {}: launches of an eager step {}; one replay's kernels {}".format(
            cell, step, replay))
        for name, entry in entries.items():
            entry[cell] = dict(launches=step[name], captured_replay=replay[name + "_kernel"],
                               sums_of_limit=worst, **times[name])
        entries["bn_apply"][cell].update(  # the three together, and what they replaced
            tail_device_ms=times["device_ms"], tail_eager_device_ms=times["eager_device_ms"],
            tail_bound_ms=times["bound_ms"])
    return list(entries.values())


# ---- phase 19b: the activation after a batch norm, in its kernels ----------
# the activation layers a batch norm's kernels apply, as the unfused pair runs them
BN_ACT_LAYERS = dict(relu=ReLu("relu"), hswish=HardSwish("hswish"))


def bn_act_shapes(make, image):
    """{(shape without the batch axis, act): how many} of a model's
    train-mode batch norms, from one train-mode forward of one image on the
    CPU: act is the activation their kernels apply ("none" where none
    follows)."""
    seen = []
    train = bn_layer_mod.batch_norm_train

    def recording(x, *args, act="none", **kw):
        seen.append((tuple(x.shape[1:]), act))
        return train(x, *args, act=act, **kw)

    net = make()
    x = torch.from_numpy(np.random.RandomState(2).randn(1, *image[1:], image[0])
                         .astype(np.float32))
    bn_layer_mod.batch_norm_train = recording
    try:
        with torch.no_grad():
            net._train_forward(x)
    finally:
        bn_layer_mod.batch_norm_train = train
    out = {}
    for key in seen:
        out[key] = out.get(key, 0) + 1
    return out


def bn_act_fused(a, act):
    """A batch norm and its activation in the kernels, forward and
    backward: (act(y), dx)."""
    x, gy, mean, var, gamma, beta = a
    out, norm = bn_apply(x, mean, var, gamma, beta, BN_EPS, act)
    _, _, coef = bn_bwd_reduce(gy, x, norm, gamma, beta, act)
    return out, bn_bwd_dx(gy, x, norm, coef, gamma, beta, act)


def bn_act_unfused(a, act):
    """The same pair as before the epilogue: the kernels without an
    activation, and the activation layer's own ops under autograd between
    them."""
    x, gy, mean, var, gamma, beta = a
    y, norm = bn_apply(x, mean, var, gamma, beta, BN_EPS)
    y.requires_grad_()
    with torch.enable_grad():
        out = BN_ACT_LAYERS[act].fapply(y, True)
        (g,) = torch.autograd.grad(out, y, gy)
    _, _, coef = bn_bwd_reduce(g, x, norm, gamma)
    return out.detach(), bn_bwd_dx(g, x, norm, coef)


def bn_act_times(cell, shapes, batch):
    """For each activation the cell's batch norms feed: at their shapes and
    the trained batch in fp32, one input a layer, the fused pairs against
    the unfused (in turns: unfused, fused, fused, unfused), device ms, and
    the 7-pass bound of the fused; the first layer's fused act(y) bit-equal
    to the unfused, dx within 1e-5 of its largest magnitude."""
    out = {}
    for act in ("relu", "hswish"):
        layers, elems = [], 0
        for i, ((shape, a), n) in enumerate(shapes.items()):
            for j in range(n if a == act else 0):
                layers.append(bn_train_inputs((batch,) + shape, torch.float32,
                                              2900 + 50 * i + j))
                elems += layers[-1][0].numel()
        if not layers:
            continue
        (fy, fdx), (uy, udx) = bn_act_fused(layers[0], act), bn_act_unfused(layers[0], act)
        err = float((fdx - udx).abs().max()) / float(udx.abs().max())
        torch.cuda.synchronize()
        require(torch.equal(fy, uy), "{} {}: the fused forward is not bit-equal".format(cell, act))
        require(err <= 1e-5, "{} {}: the fused dx is off by {:.3g}".format(cell, act, err))
        del fy, fdx, uy, udx
        calls = dict(fused=[lambda a=a: bn_act_fused(a, act) for a in layers],
                     unfused=[lambda a=a: bn_act_unfused(a, act) for a in layers])
        turns = [device_ms(calls[k], inner=1) for k in ("unfused", "fused", "fused", "unfused")]
        bound = 7 * elems * 4 / HBM_BYTES_PER_S * 1e3
        out[act] = dict(layers=len(layers), gb_a_pass=elems * 4 / 1e9, dx_rel_err=err,
                        unfused_device_ms=[turns[0], turns[3]],
                        fused_device_ms=[turns[1], turns[2]], fused_bound_ms=bound)
        log("  {}: {} BN -> {} pairs ({:.3f} GB a pass) at batch {}: fused {:.4f} / {:.4f} ms "
            "({:.1%} of the 7-pass bound {:.4f} ms), unfused {:.4f} / {:.4f} ms (in turns); "
            "act(y) bit-equal, dx within {:.2g}".format(
                cell, len(layers), act, elems * 4 / 1e9, batch, turns[1], turns[2],
                bound / min(turns[1:3]), bound, turns[0], turns[3], err))
        del layers, calls
        torch.cuda.empty_cache()
    return out


def phase_bn_act():
    """Phase 19b. Returns {cell: {act: times}}."""
    log("== phase 19b: the activation after a batch norm in bn_apply, bn_bwd_reduce and "
        "bn_bwd_dx, against the unfused pair, at the training cells' shapes")
    log("card:", card_line())
    cells = (("resnet18dw", fresh_resnet18, IMAGE, 2 * AUG_BATCH),
             ("mnv3l", V3L.fresh, V3L.image, 128),
             ("resnet50", lambda: ResNet50("resnet50", num_classes=1000, v1_5=True),
              (3, 224, 224), 256))
    out = {}
    for cell, make, image, batch in cells:
        shapes = bn_act_shapes(make, image)
        pairs = {act: sum(n for (_, a), n in shapes.items() if a == act)
                 for act in ("none", "relu", "hswish")}
        log("  {}: train-mode batch norms by the activation their kernels apply: {}".format(
            cell, pairs))
        out[cell] = dict(pairs=pairs, **bn_act_times(cell, shapes, batch))
    return out


# ---- phase 19c: the bias pass of the served forward --------------------------
BULK_BATCH = 256  # the bulk serving cell's batch


def phase_bias_act():
    """Phase 19c. Returns the numbers."""
    log("== phase 19c: the bias pass (bias_act) at MobileNet-V3-Large's {} served layers, "
        "batch {}, fp32, against the eager add and activation".format(
            sum(n for *_, n in V3L_BIAS), BULK_BATCH))
    log("card:", card_line())
    layers, elems = [], 0
    g = torch.Generator(device=DEVICE).manual_seed(19)
    for shape, act, n in V3L_BIAS:
        for _ in range(n):
            y = torch.randn((BULK_BATCH,) + shape, generator=g, device=DEVICE) * 3.0
            layers.append((y, torch.randn(shape[-1], generator=g, device=DEVICE), act))
            elems += y.numel()
    with torch.no_grad():
        for i, a in enumerate(layers):
            require(torch.equal(bias_act(*a), bias_act_plain(*a)),
                    "bias_act at layer {} {}: not bit-equal to the eager ops".format(
                        i, tuple(a[0].shape)))
        calls = dict(fused=[lambda a=a: bias_act(*a) for a in layers],
                     unfused=[lambda a=a: bias_act_plain(*a) for a in layers])
        turns = [device_ms(calls[k], inner=1) for k in ("unfused", "fused", "fused", "unfused")]
        # the host's µs to queue the 48 layers once, in turns
        host = [enqueue_us(lambda k=k: [fn() for fn in calls[k]], calls=5)
                for k in ("unfused", "fused", "fused", "unfused")]
    bound = 2 * elems * 4 / HBM_BYTES_PER_S * 1e3
    log("  {} layers ({:.3f} GB a pass), every output bit-equal to the eager ops: bias_act "
        "{:.4f} / {:.4f} ms ({:.1%} of the 2-pass bound {:.4f} ms), eager add and activation "
        "{:.4f} / {:.4f} ms (device ms, in turns); host µs to queue the 48: bias_act {:.0f} / "
        "{:.0f}, eager {:.0f} / {:.0f}".format(
            len(layers), elems * 4 / 1e9, turns[1], turns[2], bound / min(turns[1:3]), bound,
            turns[0], turns[3], host[1], host[2], host[0], host[3]))
    del layers, calls
    torch.cuda.empty_cache()
    return dict(layers=sum(n for *_, n in V3L_BIAS), batch=BULK_BATCH, gb_a_pass=elems * 4 / 1e9,
                fused_device_ms=[turns[1], turns[2]], unfused_device_ms=[turns[0], turns[3]],
                fused_bound_ms=bound, fused_host_us=[host[1], host[2]],
                unfused_host_us=[host[0], host[3]])


# ---- phase 20: ConvNeXt-T's 7x7 depthwise weight gradient ------------------
DW7_BATCH = 128  # the ConvNeXt-T cell's batch
DW7_BF16_BATCH = 8
DW7_STAGES = [(56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3)]  # H = W, C, layers
DW7_RTOL = 1e-5  # of the sum of the terms' magnitudes, per tap
DW7_IMAGE, DW7_CLASSES = 224, 1000  # the cell's images and classes
DW7_REPLAY = ("depthwise7x7_dw_partial_kernel", "depthwise7x7_dw_finish_kernel",
              "wgrad2d_grouped")  # the kernel's two kernels, and cuDNN's it replaced


def dw7_inputs(N, H, C, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn((N, H, H, C), generator=g, device=DEVICE).to(dtype)
                 for _ in range(2))


def dw7_check(N, H, C, dtype):
    """The kernel at (N,H,H,C) against the fp64 sum of the same inputs, and
    two runs bit-equal. Returns its error and the plain version's, relative
    to the sum of the terms' magnitudes."""
    x, g = dw7_inputs(N, H, C, dtype, N + H + C)
    dw, again = depthwise7x7_dw(x, g), depthwise7x7_dw(x, g)
    plain = depthwise7x7_dw_plain(x, g)
    x, g = x.double(), g.double()
    ref = depthwise7x7_dw_plain(x, g)
    mag = depthwise7x7_dw_plain(x.abs(), g.abs()).clamp_min(1e-30)
    err = float(((dw.double() - ref).abs() / mag).max())
    plain_err = float(((plain.double() - ref).abs() / mag).max())
    shape = (N, H, H, C)
    require(torch.equal(dw, again), "depthwise7x7_dw {} {}: two runs differ".format(shape, dtype))
    require(err < DW7_RTOL, "depthwise7x7_dw {} {}: {:.3e} from the fp64 sum".format(
        shape, dtype, err))
    bands = load_library().lib.dorknet_depthwise7x7_dw_bands(
        N, H, C, sm_count(torch.cuda.current_device()))
    log("  {} {} in {} bands: {:.3e} of the terms' magnitudes from the fp64 sum (the plain "
        "version {:.3e}), two runs bit-equal".format(shape, str(dtype)[6:], bands, err,
                                                     plain_err))
    del x, g, ref, mag
    torch.cuda.empty_cache()
    return err


def dw7_step_launches():
    """ConvNeXt-T under AdamW at the cell's batch and image size: the
    wrapper's launches in an eager Trainer.step (by route too), then one
    replay of the captured step: the kernels of ``DW7_REPLAY`` by name."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(DW7_BATCH, 3, DW7_IMAGE, DW7_IMAGE).astype(np.float32))
    y = np.eye(DW7_CLASSES, dtype=np.float32)[rng.randint(0, DW7_CLASSES, DW7_BATCH)]
    x, y = x.to(DEVICE), torch.from_numpy(y).to(DEVICE)

    def trainer(cuda_graph):
        np.random.seed(7)
        net = ConvNeXt("convnext_t", num_classes=DW7_CLASSES)
        return Trainer(net, AdamW(net, 1.25e-4), device=DEVICE, cuda_graph=cuda_graph)

    eager = trainer(False)
    eager.step(x, y)  # adoption
    torch.cuda.synchronize()
    reset_launches([depthwise7x7_dw])
    eager.step(x, y)
    torch.cuda.synchronize()
    step = dict(launches=depthwise7x7_dw.launches,
                launches_by_route=dict(depthwise7x7_dw.launches_by_route))
    del eager
    torch.cuda.empty_cache()
    captured = trainer(True)
    for _ in range(3):  # adoption, warm-up and capture, a replay
        captured.step(x, y)
    reset_launches([depthwise7x7_dw])
    replay, _, _, _ = replay_profile(lambda: captured.step(x, y), DW7_REPLAY)
    require(step == dict(launches=18, launches_by_route=dict(strip=18))
            and replay == dict(zip(DW7_REPLAY, (18, 18, 0))) and captured.captures == 1
            and depthwise7x7_dw.launches == 0,
            "ConvNeXt-T's step: the 7x7 weight gradient launched {} eagerly and {} in a "
            "replay, where 18 and 18 each are due".format(step, replay))
    del captured, x, y
    torch.cuda.empty_cache()
    return step, replay


def phase_dw7x7():
    """Phase 20. Returns the kernels line's entry."""
    log("== phase 20: the 7x7 depthwise weight gradient (depthwise7x7_dw) at ConvNeXt-T's "
        "stage shapes: against its plain version at batch {} (fp32) and {} (bf16), timed at "
        "batch {}; its launches in ConvNeXt-T's step".format(DW7_BATCH, DW7_BF16_BATCH,
                                                              DW7_BATCH))
    log("card:", card_line())
    max_err = 0.0
    for H, C, _ in DW7_STAGES:
        for N, dtype in ((DW7_BATCH, torch.float32), (DW7_BF16_BATCH, torch.bfloat16)):
            max_err = max(max_err, dw7_check(N, H, C, dtype))
    stages, sums = [], dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, library_ms=0.0)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for H, C, layers in DW7_STAGES:
            x, g = dw7_inputs(DW7_BATCH, H, C, torch.float32, 20 + C)
            xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            kern = [lambda: depthwise7x7_dw(x, g)]
            lib = [lambda: torch.nn.grad.conv2d_weight(xc, (C, 1, 7, 7), gc, padding=3,
                                                        groups=C)]
            turns = [device_ms(kern, inner=10), device_ms(lib, inner=1, repeats=2),
                     device_ms(kern, inner=10)]
            plain = device_ms([lambda: depthwise7x7_dw_plain(x, g)], inner=1, repeats=2)
            bound = dw_k_bound_ms(DW7_BATCH, H, H, C, 1, k=7)
            ms = min(turns[0], turns[2])
            stages.append(dict(shape=[DW7_BATCH, H, H, C], layers=layers, ms=[turns[0], turns[2]],
                               bound_ms=bound, plain_ms=plain, library_ms=turns[1]))
            for key, v in (("ms", ms), ("bound_ms", bound), ("plain_ms", plain),
                           ("library_ms", turns[1])):
                sums[key] += layers * v
            log("  {} x {}: kernel {:.4f} / {:.4f} ms ({:.1%} of the bound {:.4f} ms), plain "
                "{:.4f}, cuDNN {:.4f} (device ms, in turns)".format(
                    (DW7_BATCH, H, H, C), layers, turns[0], turns[2], bound / ms, bound, plain,
                    turns[1]))
            del x, g, xc, gc
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    log("  the 18 layers: kernel {:.4f} ms ({:.1%} of the bound {:.4f} ms), plain {:.4f}, "
        "cuDNN {:.4f}".format(sums["ms"], sums["bound_ms"] / sums["ms"], sums["bound_ms"],
                              sums["plain_ms"], sums["library_ms"]))
    step, replay = dw7_step_launches()
    log("  ConvNeXt-T at batch {} and {} px: launches of an eager step {}; one replay's "
        "kernels {}".format(DW7_BATCH, DW7_IMAGE, step, replay))
    return dict(name="depthwise7x7_dw", route="cuda",
                source="dorknet_tpu_torch/csrc/depthwise7x7_dw.cu", replaces=None,
                captured_replay={k: replay[k] for k in DW7_REPLAY[:2]}, **step,
                max_rel_err=max_err, stages=stages, **sums)


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
    del runner  # the two networks serve phase 15
    bwd_err = phase_bwd_vs_plain()
    bn_err = phase_bn_stats_vs_plain()
    bn = phase_bn_stats_times()
    launches, train_routes = phase_train()
    phase_train_twin()
    bwd = phase_bwd_times()
    aug = phase_augment_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        aug_launches, dd = phase_aug_slice(os.path.join(tmp, "packed"))
        mm, mm_stats = phase_gemm()
        ab_launches, ab_routes = phase_bn_fuse_ab()
        acc_launches = phase_accumulate()
        graph_launches, replay, captured = phase_captured(dd)
        del dd
        captured_img_s = 2 * AUG_BATCH / captured["step_augmented_indexed"]["captured"]["ms"] * 1e3
        p14_launches, p14_gemm, p14 = phase_14(tmp, os.path.join(tmp, "packed"), captured_img_s)
        p15_launches, p15 = phase_cam(net_cpu, net_gpu, tmp)
        del net_cpu, net_gpu
        p16_launches, p16_replay, p16 = phase_zoo(MNV2, "16")
        p17_launches, p17 = phase_mnist(tmp)
    p18_launches, p18_replay, p18 = phase_zoo(V3L, "18")
    p18e_launches, p18e = phase_deep_zoo()
    p18_launches.update(p18e_launches)
    p18["deep_zoo"] = p18e
    bn_train = phase_bn_train()
    bn_act = phase_bn_act()
    bias = phase_bias_act()
    dw7 = phase_dw7x7()

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

    def phase14(i):
        """AUG_KERNELS[i]'s launches in each run of phase 14 (counts set to
        0 just before each, read just after)."""
        return dict(zip(("checkpoint", "network_test", "script"),
                        (counts[i] for counts in p14_launches)))

    captured_steps = {k: captured[k] for k in ("step", "step_augmented_indexed",
                                                 "accumulate_step", "capture_seconds",
                                                 "peak_mb", "pool_mb", "remat", "held")}
    log(json.dumps({"captured_steps": captured_steps}))
    log(json.dumps({"phase14": p14}))
    log(json.dumps({"phase15": p15}))
    log(json.dumps({"phase16": p16}))
    log(json.dumps({"phase17": p17}))
    log(json.dumps({"phase18": p18}))
    log(json.dumps({"phase19b": bn_act}))
    log(json.dumps({"phase19c": bias}))
    replay_names = dict(zip((k.__name__ for k in TRAIN_KERNELS), (n for n, _ in MNV2.replay)))
    kernels = [
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
             captured_run_launches=captured_run(1), phase14_launches=phase14(1), **folded),
        dict(name="depthwise3x3_dx", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[1], max_abs_err=bwd_err["dx"], ms=bwd["dx"],
             plain_ms=bwd["dx_plain"], bound_ms=bound_ms, bound_by=bound_by,
             library_ms=bwd["dx_cudnn"], launches_by_route=train_routes[1],
             captured_replay_launches=replayed("depthwise3x3_dx_vec_kernel"),
             captured_run_launches=captured_run(2), phase14_launches=phase14(2),
             **bwd_device("dx"), **entry),
        dict(name="depthwise3x3_dw", source="dorknet_tpu_torch/csrc/depthwise3x3_bwd.cu",
             launches=launches[2], max_abs_err=bwd_err["dw"], ms=bwd["dw"],
             plain_ms=bwd["dw_plain"], bound_ms=dw_bound, bound_by=dw_by,
             library_ms=bwd["dw_cudnn"], launches_by_route=train_routes[2],
             captured_replay_launches=replayed("depthwise3x3_dw_vec_kernel"),
             captured_run_launches=captured_run(3), phase14_launches=phase14(3),
             **bwd_device("dw"), **entry),
        dict(name="augment_planes_fused", route="cuda",
             source="dorknet_tpu_torch/csrc/augment_planes.cu",
             replaces="dorknet_tpu/ops/pallas/augment.py:205", launches=aug_launches[0],
             library_ms=None,
             captured_replay_launches=replayed("augment_band_kernel"),
             captured_run_launches=captured_run(0), phase14_launches=phase14(0), **aug),
        dict(name="batch_norm_stats", route="cuda", source="dorknet_tpu_torch/csrc/bn_stats.cu",
             replaces="dorknet_tpu/ops/pallas/bn_stats.py:34", launches=launches[3],
             max_abs_err=bn_err, captured_replay_launches=replayed("bn_stats_partial_kernel"),
             captured_run_launches=captured_run(4), phase14_launches=phase14(4), **bn),
        dict(name="matmul", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             tensor_core_source="dorknet_tpu_torch/csrc/matmul_sm90.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:26", launches=ab_launches[0],
             launches_by_route=ab_routes[0], captured_replay_launches=replayed(*GEMM_KERNELS),
             phase14_launches=p14_gemm[0], **mm),
        dict(name="matmul_bn_stats", route="cuda", source="dorknet_tpu_torch/csrc/matmul.cu",
             tensor_core_source="dorknet_tpu_torch/csrc/matmul_sm90.cu",
             replaces="dorknet_tpu/ops/pallas/matmul.py:78", launches=ab_launches[1],
             launches_by_route=ab_routes[1], captured_replay_launches=replayed(*GEMM_KERNELS),
             phase14_launches=p14_gemm[1], **mm_stats),
    ]
    for entry in kernels:
        # launches in each run of phases 15-18 (counts set to 0 just before
        # each, read just after), and in one replay of phase 16's and phase
        # 18's captured steps
        name = entry["name"]
        entry["phase15_launches"] = {run: counts[name] for run, counts in p15_launches.items()}
        for key, runs, replay in (("phase16_launches", p16_launches, p16_replay),
                                  ("phase18_launches", p18_launches, p18_replay)):
            entry[key] = {run: counts[name] for run, counts in runs.items()}
            if name in replay_names:
                entry[key]["captured_replay"] = replay[replay_names[name]]
            elif name in ("matmul", "matmul_bn_stats"):  # the three GEMM kernels, by name
                entry[key]["captured_replay"] = sum(replay[n] for n in GEMM_KERNELS)
        entry["phase17_launches"] = p17_launches[name]
    log(json.dumps({"kernels": kernels + bn_train + [dw7]}))
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
