"""Training cells: the program's ``Trainer`` (one captured CUDA graph a step
on the card), driven step after step with the loss read to the host every
step, as the training scripts read it.

Set-up builds the network and its optimiser once, makes the data on the
card from the seed, and drives the first ``check_steps`` steps through the
window's own call and feed (the first call with a new key is the eager
warm-up step and the capture; the rest are replays), then ``warm_steps``
more. The window then runs the same call for ``--seconds``. The parameters
before the first step, what the first step leaves in public state and the
parameters and running statistics after the checked steps are kept; once the window has
closed and the program is freed, the plain reference trains the same
weights on the same inputs and the two are compared:

- ``loss_gap``: the largest relative gap of a checked step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's worked out from its state after that step);
- ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the checked steps (leaves whose reference
  gradient is under a thousandth of the median leaf's left out);
- ``stats_gap``: the same for the batch norms' running statistics.

A leaf's gap is measured against the larger of the reference's norm of that
leaf and of the median leaf.

The mix's ``entry`` names its feed (``feeds/<entry>.py``), the
configuration's optimiser its module (``optimisers/<name>.py``), which also
says how the program's first gradient is read from public state: the
parameters' change over the first step, or the optimiser state as the
program's checkpoint holds it.
"""

import math
import time

import torch

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import checks, faults, program, trace, weights
from benchmark_torch.harness.device import memory_peak
from benchmark_torch.reference import train as ref_train
from benchmark_torch.reference.plain import layer_table
from benchmark_torch.work import counts




class FirstStep:
    """What the first step leaves in public state: each parameter's change
    (``delta``, name -> float64 tensor) and the optimiser state as the
    program's checkpoint holds it (``opt_cache()``, read only by an
    optimiser that needs it)."""

    def __init__(self, delta, net, trainer, names):
        self.delta, self._net, self._trainer, self._names = delta, net, trainer, names

    def opt_cache(self):
        from dorknet_tpu_torch.utils.torch_io import state_tree

        return dict(zip(self._names, state_tree(self._net, self._trainer)["opt_cache"]))


def _program_side(rec, feed, spec, params0, stats0):
    """Set-up, the window, the traced slice and the readers, on the
    program. Returns what the comparison needs; every program object is
    dropped on return."""
    cfg, mix, dev = rec.cell.config, rec.cell.traffic, rec.device
    from dorknet_tpu_torch.network import Trainer

    opt = cells.optimiser(rec.cell)
    net, placed = program.network(rec.cell, params0, stats0, dev)
    trainer = Trainer(net, opt.program(cfg["train"], net), device=dev)
    faults.plant_training(rec.fault, trainer)
    rec.mark("weights made, network and trainer built")
    name_of = {id(p): k for k, p in placed.items()}
    names = [name_of[id(p)] for p in net.parameters()]

    def step(i):
        with rec.spans("step_call"):
            loss, preds = feed.call(trainer, i)
        with rec.spans("read"):
            value = float(loss)
            if mix.get("read_preds"):
                preds.cpu().numpy()
        return value

    n_check = int(mix["check_steps"])
    losses, grad_norms = [], None
    for i in range(n_check):
        losses.append(step(i))
        rec.mark("checked step {}{}".format(i, " (eager warm-up and capture)" if i == 0 else ""))
        if i == 0:
            delta = {k: p.detach().reshape(params0[k].shape).double() - params0[k].double()
                     for k, p in placed.items()}
            grad_norms = opt.first_grad_norms(cfg["train"],
                                              FirstStep(delta, net, trainer, names))
            del delta
    after = {k: p.detach().reshape(params0[k].shape).clone() for k, p in placed.items()}
    stats_after = weights.program_stats(net, set(stats0))
    i = n_check
    for _ in range(int(mix["warm_steps"])):
        step(i)
        i += 1
    rec.note("set-up: {} captured graphs, the last captured in {:.4f} s; losses of the "
             "checked steps {}".format(trainer.captures, trainer.capture_seconds, losses))

    start = time.perf_counter()
    rec.e2e["setup_s"] = start - rec.t0
    steps = bad = 0
    while True:
        bad += not math.isfinite(step(i))
        i += 1
        steps += 1
        if time.perf_counter() - start >= rec.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    end = time.perf_counter()
    rec.window, rec.images = (start, end), steps * feed.images_per_step
    rec.attempted, rec.failed = steps, bad
    rec.e2e["train_img_per_s"] = rec.images / (end - start)
    rec.note("window: {} steps, {} images in {:.4f} s; {} losses not finite".format(
        steps, rec.images, end - start, bad))

    if rec.trace and dev.type == "cuda":
        def slice_steps():
            nonlocal i
            for _ in range(int(mix["trace_steps"])):
                step(i)
                i += 1

        rec.slice = trace.profile_slice(slice_steps, rec.spans)
    rec.memory_peak = memory_peak(dev)
    rec.handles = feed.handles() if rec.trace else {}
    rec.read_layers()
    rec.handles = {}
    return losses, grad_norms, after, stats_after


def run(rec):
    cfg, mix, dev = rec.cell.config, rec.cell.traffic, rec.device
    forward = cells.reference(rec.cell).forward
    feed = cells.feed(rec.cell)(cfg, mix, rec.seed, dev)
    rec.mark("data made")
    spec, rec.layers, _ = layer_table(forward, cfg, feed.images_per_step)
    rec.counters["train_flops_per_image"] = counts.train_flops_per_image(rec.layers)
    params0 = weights.make_params(spec, rec.seed, dev, dense_std=0.01)
    stats0 = weights.train_stats(spec, params0)
    rec.mark("weights made")
    losses, grad_norms, after, stats_after = _program_side(rec, feed, spec, params0, stats0)
    n_check = len(losses)
    batches = list(feed.reference_batches(feed.keep_for_reference(n_check), dev))
    del feed
    program.release(dev)

    opt = cells.optimiser(rec.cell).Reference(cfg["train"], params0)
    params, stats, ref_losses, grads0 = params0, stats0, [], None
    for x, y in batches:
        loss, grads, stats = ref_train.step(forward, cfg, params, stats, x, y)
        grads0 = grads if grads0 is None else grads0
        params = opt.apply(params, grads)
        ref_losses.append(loss)
    rec.note("reference losses of the checked steps {}".format(ref_losses))
    rec.checks["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    rec.checks["grad_gap"], leaf = checks.worst_leaf(
        grad_norms, {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads0.items()})
    rec.note("grad_gap worst leaf:", leaf)
    keep = checks.moved(grads0)
    rec.checks["change_gap"], leaf = checks.worst_leaf(
        {k: after[k] - params0[k] for k in keep}, {k: params[k] - params0[k] for k in keep})
    rec.note("change_gap worst leaf: {}; {} of {} leaves compared".format(
        leaf, len(keep), len(params0)))
    prog_d, ref_d = {}, {}
    for name, (m0, s0) in stats0.items():
        for j, part in enumerate(("mean", "std")):
            prog_d[name + "/" + part] = stats_after[name][j] - (m0, s0)[j]
            ref_d[name + "/" + part] = stats[name][j] - (m0, s0)[j]
    rec.checks["stats_gap"], leaf = checks.worst_leaf(prog_d, ref_d)
    rec.note("stats_gap worst leaf:", leaf)
