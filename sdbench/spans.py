"""What the host was doing while the card idled: the program's `sd.*` spans
(`structuredetector_tpu_torch/tracing.py`) in a traced run's `Reduced`.

Every idle instant of the window (outside `Reduced.busy`) goes to the
garbage collector where an `sd.gc.*` span on any thread covers it (a
collection holds the interpreter lock, so every thread stands still),
else to the innermost `sd.*` span open at that instant on the loop's
thread: the thread that holds the `sd.predict.submit` or `sd.train.step`
spans. The metric readers add up the seconds of their spans and give them
as a share of the window, so one cell's shares add up to at most its
`device_idle`. The benchmark's profiler traces only the thread that
started it (and autograd's): a collection that another thread runs (the
loader's coordinator) is not in the trace, and its pause counts towards
the span then open on the loop.

A reading is None where the trace has no device operations (a CPU run),
no loop (a program without spans) or none of the metric's spans in the
window (a span renamed or taken away): never 0 for a span that is not
there.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from sdbench.trace import _union

GC = "gc"  # the key of idle time under a collection
LOOP_SPANS = ("sd.predict.submit", "sd.train.step")

SUBMIT = ("sd.predict.submit", "sd.predict.prep", "sd.predict.h2d", "sd.predict.forward",
          "sd.predict.decode")
MATERIALIZE = ("sd.predict.materialize",)
LOADER = ("sd.loader.wait", "sd.loader.h2d")
DISPATCH = ("sd.train.step", "sd.train.augment", "sd.train.encode", "sd.train.forward",
            "sd.train.backward", "sd.train.optimizer")


def _gaps(trace) -> List[Tuple[int, int]]:
    """The window less `trace.busy` (sorted, disjoint, clipped to it)."""
    w0, w1 = trace.window
    edges = [w0] + [x for iv in trace.busy for x in iv] + [w1]
    return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]


@functools.lru_cache(maxsize=1)  # a cell's readers share one trace
def idle_by_span(trace) -> Optional[Dict[str, float]]:
    """Seconds of the window's idle time by what covered them: `GC`, the
    name of the innermost `sd.*` span on the loop's thread, or "" (no
    span). Every such span found in the window has a key (0.0 where the
    card never idled under it), `GC` where a collection was found. None
    where the trace has no device operations or no loop."""
    if not trace.device_ops:
        return None
    w0, w1 = trace.window
    loops = Counter(t for n, s, e, t, _ in trace.host
                    if n in LOOP_SPANS and e > w0 and s < w1)
    if not loops:
        return None
    loop = loops.most_common(1)[0][0]
    clip = [(n, max(s, w0), min(e, w1), t) for n, s, e, t, _ in trace.host
            if n.startswith("sd.") and e > w0 and s < w1]
    in_gc = _union([(s, e) for n, s, e, _ in clip if n.startswith("sd.gc.")])
    spans = sorted((s, e, n) for n, s, e, t in clip
                   if t == loop and not n.startswith("sd.gc."))
    idle = _gaps(trace)

    seconds: Dict[str, float] = {"": 0.0, **{n: 0.0 for _, _, n in spans}}
    if in_gc:
        seconds[GC] = 0.0
    points = {w0, w1}
    for s, e in idle + in_gc:
        points.update((s, e))
    for s, e, _ in spans:
        points.update((s, e))
    points = sorted(points)

    active: List[Tuple[int, int, str]] = []
    i_idle = i_gc = i_span = 0
    for p, q in zip(points, points[1:]):
        while i_idle < len(idle) and idle[i_idle][1] <= p:
            i_idle += 1
        if i_idle == len(idle):
            break
        while i_span < len(spans) and spans[i_span][0] <= p:
            active.append(spans[i_span])
            i_span += 1
        active = [a for a in active if a[1] > p]
        if idle[i_idle][0] > p:  # the card is busy over [p, q)
            continue
        while i_gc < len(in_gc) and in_gc[i_gc][1] <= p:
            i_gc += 1
        if i_gc < len(in_gc) and in_gc[i_gc][0] <= p:
            key = GC
        elif active:
            # innermost: the latest to start, and of two that start
            # together the first to end
            key = max(active, key=lambda a: (a[0], -a[1]))[2]
        else:
            key = ""
        seconds[key] += (q - p) / 1e9
    return seconds


def idle_share(trace, names: Iterable[str]) -> Optional[float]:
    """The share of the window, in %, in which the card idled under one of
    `names` (keys of `idle_by_span`); None where nothing could be read or
    none of `names` is in the window."""
    by_span = idle_by_span(trace)
    if by_span is None or trace.window_s <= 0:
        return None
    found = [by_span[n] for n in names if n in by_span]
    if not found:
        return None
    return 100.0 * sum(found) / trace.window_s
