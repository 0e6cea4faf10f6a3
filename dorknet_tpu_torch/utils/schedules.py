"""Learning-rate schedules (counterpart of ``dorknet_tpu/utils/schedules.py``).

The reference adjusts the lr imperatively from the training script
(``sgd.multiply_learning_rate(0.5)`` at hand-picked epochs); that still
works. A schedule is the declarative alternative: a pure ``t -> lr``
function plus ``apply(optimiser, t)``, which sets the value through
``set_learning_rate``. The optimiser fills its device lr (``device_lr()``,
a 0-dim fp32 tensor) in place, so a change reaches the next step, a replayed
CUDA graph included, with no recapture and no transfer per step.

Schedules are host-side on purpose, as in the JAX package: ``lr_at`` is
plain Python arithmetic in doubles, and only ``apply`` touches the device.
"""

import math


class LRSchedule:
    """Base: subclasses implement ``lr_at(t) -> float`` for t = 0, 1, 2, ...
    (epochs in the reference's loops, but any step unit works)."""

    def lr_at(self, t):
        raise NotImplementedError

    def __call__(self, t):
        return self.lr_at(t)

    def apply(self, optimiser, t):
        """Set ``optimiser``'s lr for time t. Returns the lr (for logging)."""
        lr = float(self.lr_at(t))
        optimiser.set_learning_rate(lr)
        return lr


class StepDecay(LRSchedule):
    """``base_lr`` multiplied by ``factor`` at each milestone (the
    reference's schedule shape): ``StepDecay(0.015, (16, 20, 25), 0.5)`` is
    the dogs example's lr trajectory; per-milestone factors via a dict,
    ``StepDecay(0.01, {5: 0.1, 10: 0.1})``."""

    def __init__(self, base_lr, milestones, factor=0.5):
        self.base_lr = float(base_lr)
        if isinstance(milestones, dict):
            self.milestones = {int(k): float(v) for k, v in milestones.items()}
        else:
            self.milestones = {int(m): float(factor) for m in milestones}

    def lr_at(self, t):
        lr = self.base_lr
        for m in sorted(self.milestones):
            if t >= m:
                lr *= self.milestones[m]
        return lr


class CosineDecay(LRSchedule):
    """Half-cosine from ``base_lr`` to ``base_lr * min_frac`` over ``total``
    units; constant at the floor afterwards."""

    def __init__(self, base_lr, total, min_frac=0.0):
        if total <= 0:
            raise ValueError("total must be positive")
        self.base_lr = float(base_lr)
        self.total = int(total)
        self.min_frac = float(min_frac)

    def lr_at(self, t):
        frac = min(max(t / self.total, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.base_lr * (self.min_frac + (1 - self.min_frac) * cos)


class Warmup(LRSchedule):
    """Linear ramp 0 -> schedule(warmup) over ``warmup`` units, then the
    wrapped schedule evaluated at t (the usual large-batch recipe)."""

    def __init__(self, schedule, warmup):
        if warmup < 0:
            raise ValueError("warmup must be >= 0")
        self.schedule = schedule
        self.warmup = int(warmup)

    def lr_at(self, t):
        if self.warmup and t < self.warmup:
            return self.schedule.lr_at(self.warmup) * (t + 1) / self.warmup
        return self.schedule.lr_at(t)
