"""Mean host ms of the ``Trainer.step*`` calls of the window, without the
loss read that follows each."""

from benchmark_torch.harness.timing import mean_ms


def read(rec):
    return mean_ms(rec.spans.durations("step_call", *rec.window))
