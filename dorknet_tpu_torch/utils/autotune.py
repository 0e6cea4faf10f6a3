"""Device timing for tuning and A/B harnesses (counterpart of
``dorknet_tpu/utils/autotune.py``; only ``measure_device_ms`` is ported, the
batch-size tuner waits for its slice).

The JAX package reads device time from a ``jax.profiler`` trace; here CUDA
events on the current stream bracket each call. There is no device time on
the CPU, so a measurement without a card raises rather than report a host
time under a device metric's name.
"""

import statistics

import torch


def measure_device_ms(thunk, runs=3, warmup=1):
    """Median device ms of one call of ``thunk`` over ``runs`` calls, after
    ``warmup`` calls, each bracketed by CUDA events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_device_ms needs a CUDA device")
    for _ in range(warmup):
        thunk()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
