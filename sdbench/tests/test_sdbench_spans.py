"""The readers of the device's idle time under the program's spans
(`sdbench/spans.py`, `sdbench/metrics/idle_*.py`), on a `Reduced` built
from synthetic trace events: innermost span, a collection on another
thread first, busy time left out, a cell's shares within its idle share,
None without spans, or without a metric's own spans."""

from types import SimpleNamespace

import pytest

from sdbench import run, spans
from sdbench.trace import Reduced

MS = 1_000_000
LOOP, OTHER = 11, 12
INFER = ("idle_gc.infer", "idle_submit.infer", "idle_materialize.infer")
TRAIN = ("idle_loader.train", "idle_dispatch.train")


class Event:
    """The part of a kineto event that `Reduced` reads."""

    def __init__(self, name, start_ms, end_ms, thread=LOOP, device=False):
        self._name, self._s, self._e = name, int(start_ms * MS), int(end_ms * MS)
        self._thread, self._device = thread, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def activity_type(self):
        return "kernel" if self._device else "user_annotation"

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return 0


def kernels(*intervals):
    return [Event(f"k{i}", s, e, device=True) for i, (s, e) in enumerate(intervals)]


def read_all(names, events, window_ms=(0, 100)):
    trace = Reduced(events, (window_ms[0] * MS, window_ms[1] * MS))
    ctx = SimpleNamespace(trace=trace)
    return trace, {n: run.metric_reader(n)(ctx) for n in names}


def train_events():
    """Busy [0, 10), [40, 50), [90, 100) ms. On the loop: a step over
    [10, 30) with its forward over [12, 20); a loader wait over [30, 45);
    a step over [55, 80), during which a collection runs on another
    thread over [60, 70); nothing over [50, 55) and [80, 90)."""
    return kernels((0, 10), (40, 50), (90, 100)) + [
        Event("sd.train.step", 10, 30), Event("sd.train.forward", 12, 20),
        Event("sd.loader.wait", 30, 45), Event("sd.train.step", 55, 80),
        Event("sd.gc.gen2", 60, 70, thread=OTHER),
        Event("sdbench.epoch", 0, 100), Event("aten::add", 14, 16),
    ]


def test_train_readers_split_idle_time():
    trace, got = read_all(TRAIN, train_events())
    assert got["idle_dispatch.train"] == pytest.approx(2 + 8 + 10 + 5 + 10)
    assert got["idle_loader.train"] == pytest.approx(10)  # busy again from 40
    assert 100 * trace.idle_share == pytest.approx(70)
    assert sum(got.values()) <= 100 * trace.idle_share
    by_span = spans.idle_by_span(trace)
    assert by_span[spans.GC] == pytest.approx(0.010)
    assert by_span[""] == pytest.approx(0.015)  # [50, 55) and [80, 90)
    assert by_span["sd.train.forward"] == pytest.approx(0.008)


def test_innermost_span_takes_the_instant():
    events = kernels((0, 1)) + [
        Event("sd.predict.collect", 10, 60), Event("sd.predict.fetch", 10, 20),
        Event("sd.predict.materialize", 20, 50),
        Event("sd.predict.submit", 60, 100), Event("sd.predict.prep", 60, 70),
        Event("sd.predict.h2d", 70, 80), Event("sd.predict.forward", 80, 90),
        Event("sd.predict.decode", 90, 100),
    ]
    _, got = read_all(INFER, events)
    assert got["idle_submit.infer"] == pytest.approx(40)
    assert got["idle_materialize.infer"] == pytest.approx(30)  # not the collect's
    assert got["idle_gc.infer"] is None  # no collection in the trace


def test_a_collection_on_any_thread_comes_first():
    events = kernels((0, 1)) + [
        Event("sd.predict.submit", 10, 50), Event("sd.predict.materialize", 50, 90),
        Event("sd.gc.gen2", 40, 60, thread=OTHER), Event("sd.gc.gen0", 80, 85),
    ]
    _, got = read_all(INFER, events)
    assert got["idle_gc.infer"] == pytest.approx(25)
    assert got["idle_submit.infer"] == pytest.approx(30)
    assert got["idle_materialize.infer"] == pytest.approx(20 + 5)


def test_busy_time_is_left_out():
    events = kernels((10, 30), (20, 40), (60, 100)) + [
        Event("sd.train.step", 0, 100), Event("sd.gc.gen1", 25, 45, thread=OTHER)]
    trace, got = read_all(TRAIN, events)
    assert got["idle_dispatch.train"] == pytest.approx(10 + 15)
    assert spans.idle_by_span(trace)[spans.GC] == pytest.approx(0.005)
    assert got["idle_loader.train"] is None  # no loader span in the trace


def test_spans_outside_the_window_are_clipped():
    events = kernels((20, 30)) + [Event("sd.train.step", -50, 150)]
    trace, got = read_all(("idle_dispatch.train",), events, window_ms=(0, 100))
    assert got["idle_dispatch.train"] == pytest.approx(90)
    assert got["idle_dispatch.train"] == pytest.approx(100 * trace.idle_share)


@pytest.mark.parametrize("names", [INFER, TRAIN])
def test_shares_stay_within_the_idle_share(names):
    events = train_events() + [
        Event("sd.predict.submit", 50, 58), Event("sd.predict.materialize", 84, 99),
        Event("sd.predict.decode", 52, 54)]
    trace, got = read_all(names, events)
    assert all(v is not None and v >= 0 for v in got.values())
    assert sum(got.values()) <= 100 * trace.idle_share + 1e-9


@pytest.mark.parametrize("events", [
    kernels((0, 10)) + [Event("sdbench.epoch", 0, 100), Event("aten::add", 3, 5)],
    kernels((0, 10)) + [Event("sd.gc.gen2", 20, 30), Event("sd.loader.wait", 30, 40)],
    [Event("sd.train.step", 0, 50), Event("sd.gc.gen0", 20, 30)],  # no device trace
], ids=["no_spans", "no_loop", "cpu_run"])
def test_nothing_to_read_reads_none(events):
    _, got = read_all(INFER + TRAIN, events)
    assert all(v is None for v in got.values())


@pytest.mark.parametrize("missing", ["sd.predict.materialize", "sd.gc.gen0", "sd.loader.h2d"])
def test_a_metric_whose_spans_are_missing_reads_none(missing):
    """A span renamed or taken away reads None, not 0: the others still
    read, and a span present where the card never idled reads 0."""
    events = kernels((0, 100)) + [
        Event("sd.predict.submit", 0, 40), Event("sd.predict.materialize", 40, 50),
        Event("sd.train.step", 50, 70), Event("sd.loader.h2d", 70, 80),
        Event("sd.gc.gen0", 80, 90)]
    names = INFER + TRAIN
    metric = {"sd.predict.materialize": "idle_materialize.infer",
              "sd.gc.gen0": "idle_gc.infer", "sd.loader.h2d": "idle_loader.train"}[missing]
    _, got = read_all(names, [e for e in events if e.name() != missing])
    assert got[metric] is None
    assert all(got[n] == 0 for n in names if n != metric)


def test_every_idle_metric_has_a_reader_and_lists_its_cells():
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    by_name = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert {n for n in by_name if n.startswith("idle_")} == set(INFER + TRAIN)
    for name in INFER + TRAIN:
        m = by_name[name]
        assert (run.HERE / "metrics" / f"{name}.py").is_file()
        assert m["unit"] == "%" and m["better"] == "lower" and m["source"] == "device_trace"
        assert set(m["workloads"]) <= cells
        assert m["moves"] == ("infer_img_per_s" if name.endswith(".infer")
                              else "train_img_per_s")
