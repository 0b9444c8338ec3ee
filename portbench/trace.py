"""Spans around the benchmark's calls into the program, and the reading
of a `torch.profiler` trace of the window.

A span is recorded on the host's monotonic clock (its end waits for the
device, as the program's own phase timers do) and, when the window is
traced, as a `record_function` range, so the trace can name what the
host was doing in each of the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
# host ranges that the trace mirrors on the device's timeline, which are
# no work there: the benchmark's spans, and the collectives' annotations
# (`nccl:all_gather` beside the kernel `ncclDevKernel_AllGather_...`)
MIRRORED = (SPAN_PREFIX, "nccl:")


class Spans:
    """Named host intervals of one run: `seconds[name]` sums each name's
    spans, and `within(start)` only those that began at or after `start`."""

    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.records = []  # (name, start, end)

    @contextlib.contextmanager
    def span(self, name):
        start = time.monotonic()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
        self.records.append((name, start, time.monotonic()))

    def seconds(self, since=0.0):
        out = defaultdict(float)
        for name, start, end in self.records:
            if start >= since:
                out[name] += end - start
        return dict(out)


def profiler():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def read_trace(prof, top=10):
    """Device time by name, busy seconds, the traced window and the
    longest idle gaps from a finished profile.  Returns None when the
    trace holds no device activity (the caller then reports no metric
    that needs it)."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and e.name().startswith(MIRRORED):
            continue  # a host range mirrored on the device's timeline: no work
        if on_device:
            device.append((start, end, e.name()))
        elif e.name() == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, e.name()))
    if window is None or not device:
        return None
    lo, hi = window
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    by_name = defaultdict(float)
    for s, e, n in inside:
        by_name[n] += e - s
    busy = _union([(s, e) for s, e, _ in inside])
    busy_s = sum(e - s for s, e in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)

    def doing(mid):
        """The innermost host range (span or operator) covering `mid`."""
        best = None
        for s, e, n in host:
            if s <= mid < e and (best is None or s > best[0]):
                best = (s, n)
        return best[1] if best else "none"

    return {
        "window_s": hi - lo,
        "busy_s": busy_s,
        "kernel_s": dict(by_name),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": [[doing((a + b) / 2), g] for g, a, b in gaps[:top]],
    }


def kernel_seconds(trace, *patterns):
    """Device seconds of the kernels whose name holds any of `patterns`."""
    return sum(s for name, s in trace["kernel_s"].items() if any(p in name for p in patterns))


def idle_share(trace):
    """Percent of the traced window with nothing running on the device."""
    return None if trace is None else 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def span_share(run, name):
    """Percent of the window spent in the spans called `name`."""
    seconds = run.spans.get(name)
    return None if seconds is None else 100.0 * seconds / run.window_s
