"""Closed-loop bulk scoring: host batches streamed through the program's
BN-folded ``InferenceRunner.predict_iter``, as an offline pass over an
image set runs.

Batches of ``batch`` fp32 images are cycled from a host pool of
``pool_batches`` made from the seed. The feed stops once ``--seconds`` have
passed; the batches already queued finish, and the window ends at the last
answer. The end-to-end metric is every image whose probabilities reached
the host, over the window's seconds. The comparison: every answered image
against the reference's probabilities of it (``prob_gap``).
"""

import time

import numpy as np

from benchmark_torch.harness import faults, program, trace
from benchmark_torch.harness.device import memory_peak
from benchmark_torch.harness.serving import Served, prob_gap



def stream(runner, pool, seconds, spans):
    """Run ``predict_iter`` over the pool's batches, fed until ``seconds``
    have passed. Returns (start, end, [(pool index, probs), ...])."""
    start = time.perf_counter()

    def batches():
        k = 0
        while time.perf_counter() - start < seconds:
            with spans("feed"):
                item = (pool[k % len(pool)], k % len(pool))
            yield item
            k += 1

    answers = []
    it = runner.predict_iter(batches())
    while True:
        with spans("answer"):
            out = next(it, None)
        if out is None:
            break
        answers.append((out[1], out[0]))
    return start, time.perf_counter(), answers


def run(rec):
    mix, dev = rec.cell.traffic, rec.device
    from dorknet_tpu_torch.network import InferenceRunner

    B = int(mix["batch"])
    served = Served(rec, B)
    pool = served.pool(rec, (int(mix["pool_batches"]), B))
    rec.mark("weights, calibration and pool made")
    net, _ = program.network(rec.cell, served.params, served.stats, dev)
    runner = InferenceRunner(net, batch_size=B, device=dev, fold_bn=True)
    faults.plant_serving(rec.fault, runner)
    del net
    rec.mark("runner built")
    for _ in range(2):  # the pinned rings and every kernel, before the window
        list(runner.predict_iter((pool[k], k) for k in range(len(pool))))
    rec.e2e["setup_s"] = time.perf_counter() - rec.t0
    start, end, answers = stream(runner, pool, rec.seconds, rec.spans)
    rec.window = (start, end)
    rec.images = sum(len(p) for _, p in answers)
    rec.attempted = rec.images
    rec.e2e["serve_img_per_s"] = rec.images / (end - start)
    rec.note("window: {} batches, {} images in {:.4f} s".format(len(answers), rec.images,
                                                               end - start))
    if rec.trace and dev.type == "cuda":
        rec.slice = trace.profile_slice(
            lambda: stream(runner, pool, float(mix["trace_seconds"]), rec.spans),
            rec.spans)
    rec.memory_peak = memory_peak(dev)
    rec.read_layers()
    del runner
    program.release(dev)
    ref = served.reference_probs(pool.reshape((-1,) + pool.shape[2:]), dev).reshape(
        pool.shape[:2] + (-1,))
    rec.checks["prob_gap"] = max(prob_gap(p, ref[k]) for k, p in answers) if answers else None
