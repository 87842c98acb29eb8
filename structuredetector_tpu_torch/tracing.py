"""Spans on the profiler's clock, and the garbage collector's pauses.

`span(name)` marks a piece of host work. While a `torch.profiler` runs in
the process it is `torch.profiler.record_function(name)`: the span lands
in the same trace as the kernels and copies it launches, on the same
clock (epoch nanoseconds, `time.time_ns()`). Otherwise it is one shared
null context after a single flag check, so a span costs well under a
microsecond when no one profiles. There is no switch: spans are on
exactly while a profiler runs (`cli.train --profile`, a benchmark's
traced run).

A profiler records the spans of the thread that started it and of the
threads PyTorch starts for it (autograd's); a collection that another
Python thread runs (the loader's coordinator) only where it was made to
profile all threads.

Spans of one batch or step are tied together by nesting and order:

- inference (`predictor.py`, `data/decoders.py`): `sd.predict.submit`
  over `sd.predict.prep`, `sd.predict.h2d`, `sd.predict.forward`,
  `sd.predict.decode`; `sd.predict.collect` over `sd.predict.fetch` and
  `sd.predict.materialize`;
- the loader (`data/pipeline.py`): `sd.loader.wait` (the consumer waits
  for the next batch), `sd.loader.h2d` (a staged batch's copy);
- training (`train/trainer.py`, `train/steps.py`): `sd.train.step` over
  `sd.train.augment`, `sd.train.encode`, `sd.train.forward` (the loss
  included), `sd.train.backward`, `sd.train.optimizer`;
- `sd.gc.gen0/1/2`: each collection of the garbage collector, from the
  `gc.callbacks` hook this module installs once on import. The hook
  also keeps counters whether or not anyone profiles; `counters()`
  returns them.

`train_graph_counters()` counts how the train step ran
(`train/graphs.py`): CUDA graphs captured and replayed, eager steps by
the reason a graph could not serve them, and the device memory reserved
while capturing (the graphs' shared pool). They are kept apart from the
collector's counters, which `/healthz` reports as `"gc"`.
"""

from __future__ import annotations

import contextlib
import gc
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span", "counters", "train_graph_counters"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager around host work named `name`: a profiler range
    while a profiler runs, else a shared no-op."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL


class _GcHook:
    """The `gc.callbacks` entry: counts every collection (how many, the
    seconds spent, the objects collected, per generation) and, while a
    profiler runs, wraps it in a span on the collecting thread. One
    collection runs at a time, under the interpreter lock."""

    def __init__(self):
        self.collections = [0, 0, 0]
        self.ns = [0, 0, 0]
        self.collected = [0, 0, 0]
        self._t0 = 0
        self._range = None
        # held here: a collection late in the interpreter's shutdown may
        # find the module's globals already cleared
        self._clock, self._profiler, self._record = (time.perf_counter_ns, _profiler,
                                                     record_function)

    def __call__(self, phase: str, info: dict) -> None:
        gen = info["generation"]
        if phase == "start":
            if self._profiler._is_profiler_enabled:
                self._range = self._record(f"sd.gc.gen{gen}")
                self._range.__enter__()
            self._t0 = self._clock()
            return
        self.ns[gen] += self._clock() - self._t0
        self.collections[gen] += 1
        self.collected[gen] += info["collected"]
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(None, None, None)

    def snapshot(self) -> dict:
        return {f"gen{g}": {"collections": self.collections[g],
                            "seconds": self.ns[g] / 1e9,
                            "collected": self.collected[g]} for g in range(3)}


_GC_HOOK = _GcHook()
gc.callbacks.append(_GC_HOOK)


def counters() -> dict:
    """The garbage collector's work since this module was imported:
    `{"gen0": {"collections", "seconds", "collected"}, "gen1": ..., "gen2": ...}`."""
    return _GC_HOOK.snapshot()


class TrainGraphCounter:
    """The train step's CUDA graphs, counted by `train.graphs.StepGraphs`
    and `train.steps.train_step` in every process, profiled or not."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager: dict = {}
        self.pool_bytes = 0

    def captured(self, reserved_bytes: int) -> None:
        self.captures += 1
        self.pool_bytes += reserved_bytes

    def ran_eager(self, reason: str) -> None:
        self.eager[reason] = self.eager.get(reason, 0) + 1

    def snapshot(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager": dict(self.eager), "pool_bytes": self.pool_bytes}


TRAIN_GRAPH = TrainGraphCounter()


def train_graph_counters() -> dict:
    """The train step since this module was imported: `{"captures",
    "replays", "eager": {reason: steps}, "pool_bytes"}` (`pool_bytes`: the
    device memory reserved during the captures)."""
    return TRAIN_GRAPH.snapshot()
