"""The traced run: a `torch.profiler` trace of the measured window and what
the metric readers take from it.

The window's bounds are the host clock's (`time.time_ns()`, the clock
the profiler stamps its events with), from the driver's `mark_start`: the
profiler takes seconds to start on the card. The benchmark's own ranges
(`record_function`) mark, around calls into the program, the layers a
reader needs (`sdbench.decode` around the predictor's decode). From the
device side of the trace come the kernels, copies and fills: their union
inside the window is the device's busy time, a range's device time is the
sum of the operations launched inside it (matched by correlation id), and
the longest idle gaps are named by the innermost host event that covers
each.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")


class Recorder:
    """Context manager around the window; traces only when `enabled`."""

    def __init__(self, enabled: bool, device):
        self.enabled, self.device = enabled, device
        self._prof = None
        self.bounds = (0, 0)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        if self.enabled:
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        self.mark_start()
        return self

    def mark_start(self) -> float:
        """The measured window starts now (a driver calls it where its window
        opens, after the profiler has started); returns `time.perf_counter()`."""
        self.bounds = (time.time_ns(), 0)
        return time.perf_counter()

    def __exit__(self, *exc):
        if self._prof is not None and self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)
        self.bounds = (self.bounds[0], time.time_ns())
        if self._prof is not None:
            self._prof.stop()
        return False

    def range(self, name: str):
        """A host range for the trace (a no-op context when not tracing)."""
        import contextlib

        from torch.profiler import record_function

        return record_function(name) if self.enabled else contextlib.nullcontext()

    def reduce(self) -> "Reduced":
        return Reduced(self._prof.profiler.kineto_results.events(), self.bounds)


def _device_op(e) -> bool:
    """A kernel, copy or fill on the card, not an annotation range that the
    profiler mirrors onto the device's timeline. Older profilers give no
    activity type: there an annotation is told by its flag or its name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return str(act()) in DEVICE_ACTIVITIES
    flagged = getattr(e, "is_user_annotation", None)
    return not (flagged is not None and flagged()) and not e.name().startswith("sdbench.")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class Reduced:
    """The trace's events, sorted into device operations, host ranges and
    launches, clipped to the window."""

    def __init__(self, events, window: Tuple[int, int]):
        self.device_ops: List[Tuple[str, int, int, int]] = []  # name, start, end, corr
        self.host: List[Tuple[str, int, int, int, int]] = []  # name, start, end, thread, corr
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if str(e.device_type()).endswith("CUDA"):
                if _device_op(e):
                    self.device_ops.append((e.name(), start, end, e.correlation_id()))
            else:
                self.host.append((e.name(), start, end, e.start_thread_id(), e.correlation_id()))
        self.window = win = window
        w0, w1 = win
        clipped = [(max(s, w0), min(e, w1)) for _, s, e, _ in self.device_ops if e > w0 and s < w1]
        self.busy = _union(clipped)
        self.window_s = (w1 - w0) / 1e9
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

    @property
    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 1.0 - self.busy_s / self.window_s

    def range_device_time(self, name: str) -> Tuple[int, float]:
        """(number of `name` ranges in the window, seconds of device work
        launched inside them)."""
        w0, w1 = self.window
        ranges = [(s, e, t) for n, s, e, t, _ in self.host if n == name and s >= w0 and e <= w1]
        by_thread: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for s, e, t in ranges:
            by_thread[t].append((s, e))
        for t in by_thread:
            by_thread[t].sort()
        corr = set()
        for n, s, _, t, c in self.host:
            spans = by_thread.get(t)
            if not spans or not n.startswith(("cuda", "cu")):
                continue
            i = bisect.bisect_right(spans, (s, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= s <= spans[i][1]:
                corr.add(c)
        ns = sum(e - s for _, s, e, c in self.device_ops if c in corr)
        return len(ranges), ns / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time in the window, and the
        longest idle gaps named by the innermost host event covering each."""
        w0, w1 = self.window
        by_name: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.device_ops:
            if e > w0 and s < w1:
                by_name[name] += min(e, w1) - max(s, w0)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                gaps.append((s, e))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        host = [(n, s, e) for n, s, e, _, _ in self.host]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            covering = [(hs, n) for n, hs, he in host if hs <= mid <= he]
            name = max(covering)[1] if covering else "no host event"
            named.append([name, (e - s) / 1e9])
        return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": named}


class MetricContext:
    """What a per-layer metric reader gets: the run's context (`config`,
    `traffic`, `n_out`), the window's record and the reduced trace."""

    def __init__(self, run, window: dict, trace: Reduced):
        self.run, self.window, self.trace = run, window, trace
        self.config, self.traffic, self.n_out = run.config, run.traffic, run.n_out
