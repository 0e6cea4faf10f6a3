"""A profiled slice of a run: busy and idle time of the card, device time by
kernel class and by kernel, and the idle gaps by the host span open at
their start.

Busy time is the union of the intervals in which a kernel, a copy or a
memset ran, from ``torch.profiler``'s trace: its device-side records, less
the copies of the host spans that the profiler puts on the device's
timeline. The records of single kernels
have been seen to drop out of summed profiles on an H100 host, so these
numbers give shares and breakdowns only, and never the denominator of a
roofline share (those come from ``timing.device_ms``).
"""

import bisect
import time

import torch

ELEMENTWISE = "elementwise and reductions"
# the device-side records that are not work: host ranges the profiler
# copies onto the device's timeline, and its own
NOT_WORK = ("gpu_user_annotation", "cuda_runtime", "cuda_driver")


def kernel_class(name):
    """The class of a device operation, by its name (the port's on-chip
    smoke test's classes)."""
    n = name.lower()
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copies"
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
    if "conv2d_c1_k1" in n:  # cuDNN's depthwise kernel, by its name on an H100
        return "depthwise under cuDNN"
    if "gemm" in n or "sm90_xmma" in n or "cutlass" in n or "cublas" in n:
        return "GEMM"
    if "conv" in n or "cudnn" in n or "dgrad" in n or "wgrad" in n:
        return "cuDNN conv"
    if "multi_tensor_apply" in n:
        return "optimiser (_foreach)"
    return ELEMENTWISE


def _interval(e):
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
    return start, start + dur


def _activity(e):
    """The record's kind where the profiler gives it (not every version
    does)."""
    return e.activity_type() if hasattr(e, "activity_type") else ""


class Slice:
    """The summary of one profiled slice."""

    def __init__(self, busy_s, window_s, by_class, by_name, idle_by_span):
        self.busy_s = busy_s
        self.window_s = window_s
        self.by_class = by_class        # class -> device seconds
        self.by_name = by_name          # operation name -> device seconds
        self.idle_by_span = idle_by_span  # host span -> idle seconds of the card

    def class_share(self, cls):
        total = sum(self.by_class.values())
        return 100.0 * self.by_class.get(cls, 0.0) / total if total else None

    def idle_share(self):
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.window_s > 0 else None

    def breakdown(self):
        """The ten operations that took the most device time (names cut to
        160 characters) and the card's idle time by host span."""
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def profile_slice(fn, spans):
    """Run ``fn()`` under the profiler and summarise the card's work between
    its start and the synchronise after it; ``spans`` (``timing.Spans``,
    from any thread) label the idle gaps."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time_ns()
        offset = t0 - time.perf_counter_ns()  # the profiler's clock less perf_counter's
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and _activity(e) not in NOT_WORK:
            s, f = _interval(e)
            ops.append((max(s, t0), min(f, t1), e.name()))
    ops = [o for o in ops if o[1] > o[0]]
    notes = [(offset + int(s * 1e9), offset + int(f * 1e9), name)
             for name, s, f in spans.records if f * 1e9 + offset > t0]
    return summarise(ops, notes, t0, t1)


def summarise(ops, notes, t0, t1):
    """The Slice of device operations ``ops`` [(start, end, name)] and host
    spans ``notes`` [(start, end, name)], in ns, over [t0, t1]."""
    by_class, by_name = {}, {}
    for s, f, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (f - s) / 1e9
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + (f - s) / 1e9
    busy, gaps, cursor = 0, [], t0
    for s, f, _ in sorted(ops):
        if s > cursor:
            gaps.append((cursor, s))
        if f > cursor:
            busy += f - max(s, cursor)
            cursor = f
    if t1 > cursor:
        gaps.append((cursor, t1))
    by_span = {}
    for s, f, name in sorted(notes):
        by_span.setdefault(name, ([], []))
        by_span[name][0].append(s)
        by_span[name][1].append(f)
    idle_by_span = {}
    for g0, g1 in gaps:
        label, latest = "none", None
        for name, (starts, ends) in by_span.items():  # the latest-started span open at g0
            i = bisect.bisect_right(starts, g0) - 1
            if i >= 0 and ends[i] > g0 and (latest is None or starts[i] > latest):
                label, latest = name, starts[i]
        idle_by_span[label] = idle_by_span.get(label, 0.0) + (g1 - g0) / 1e9
    return Slice(busy / 1e9, (t1 - t0) / 1e9, by_class, by_name, idle_by_span)
