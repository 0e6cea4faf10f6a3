"""Faults planted under the timed path, for the benchmark's own tests and
for reading each fault's number on the chip. None of these runs unless a
run is started with ``--fault``; a measured run never is.

- ``unchanged_state``: the optimiser's update does nothing, so a step
  returns its parameters and state unchanged.
- ``half_batch``: the loss is the mean over the first half of the batch
  only; the rest is left out.
- ``altered_answer``: in training, the reported loss is off by one part in
  a thousand; in serving, the first row of every dispatch's probabilities
  is rolled by one class.
"""

import torch

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def plant_training(fault, trainer):
    if fault is None:
        return
    net = trainer.network
    if fault == "unchanged_state":
        trainer.optimiser.apply_update = lambda params, grads, cache, lr: cache
    elif fault == "half_batch":
        loss_layer = net.loss_layer
        whole = loss_layer.fapply_loss

        def half(logits, y):
            n = logits.shape[0] // 2
            loss, _ = whole(logits[:n], y[:n])
            return loss, whole(logits.detach(), y)[1]

        loss_layer.fapply_loss = half
    elif fault == "altered_answer":
        step = net._loss_and_grads

        def altered(*args, **kwargs):
            loss, probs, grads = step(*args, **kwargs)
            return loss * 1.001, probs, grads

        net._loss_and_grads = altered
    else:
        raise ValueError("unknown fault {!r}".format(fault))


def plant_serving(fault, runner):
    if fault is None:
        return
    if fault != "altered_answer":
        raise ValueError("a serving cell has no fault {!r}".format(fault))
    forward = runner.network._test_fn

    def altered(X):
        probs = forward(X)
        return torch.cat([probs[:1].roll(1, dims=1), probs[1:]])

    runner.network._test_fn = altered
