"""The port's spans (`structuredetector_tpu_torch.tracing`) on the CPU.

Without a profiler a span is the shared null context and records nothing.
Under a CPU `torch.profiler` the predictor's, the loader's and the
trainer's spans land in the trace, nested by interval on the loop's
thread, between `time.time_ns()` readings taken around them (the trace's
clock is the host's epoch clock); every collection of the garbage
collector is a span and is counted. The benchmark's training check wraps
the trainer's module-level `train_step`: `train_epoch` must still call
it through the module.
"""

import gc
import json
import time
from collections import defaultdict

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from structuredetector_tpu_torch import tracing
from structuredetector_tpu_torch.config import Config, config_from_args
from structuredetector_tpu_torch.data.pipeline import Loader, device_prefetch
from structuredetector_tpu_torch.predictor import Predictor, PreparedImage
from structuredetector_tpu_torch.train import trainer as trainer_mod
from structuredetector_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_evaluate import _write_images

TRAIN_SIZES = [(80, 64), (100, 90), (64, 64), (70, 120)]
STEP_PHASES = ("sd.train.augment", "sd.train.encode", "sd.train.forward",
               "sd.train.backward", "sd.train.optimizer")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def traced(fn):
    """Run `fn` under a CPU profiler -> (its result, {name: [(start, end,
    thread)]} of the `sd.*` spans, time_ns before, time_ns after)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    spans = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sd."):
            spans[e.name()].append((e.start_ns(), e.end_ns(), e.start_thread_id()))
    return out, dict(spans), t0, t1


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner[2] == outer[2]


def assert_on_clock(spans, t0, t1):
    for name, found in spans.items():
        for s, e, _ in found:
            assert t0 <= s <= e <= t1, (name, s - t0, t1 - e)


def test_span_without_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("sd.a"), tracing.span("sd.b")
    assert a is b
    with a as got:
        assert got is None
    with tracing.span("sd.before"):
        pass
    _, spans, _, _ = traced(lambda: None)
    assert "sd.before" not in spans


def _predictor_config():
    cfg = Config(width=64, height=64, fpn_depth=16, max_objects=4, max_parts=8,
                 use_amp=False)
    cfg.set_labels(["bean", "maize"], ["leaf"])
    return cfg.finalize()


@pytest.mark.parametrize("prepared", [False, True])
def test_predict_batch_spans_nest_on_one_thread(prepared):
    pred = Predictor(_predictor_config(), device="cpu")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(2)]
    images = ([PreparedImage(f, (64, 64)) for f in frames] if prepared
              else [Image.fromarray(f) for f in frames])
    anns, spans, t0, t1 = traced(lambda: pred.predict_batch(images))
    assert len(anns) == 2
    assert_on_clock(spans, t0, t1)
    (submit,), (collect,) = spans["sd.predict.submit"], spans["sd.predict.collect"]
    assert submit[1] <= collect[0]
    for child in ("sd.predict.prep", "sd.predict.h2d", "sd.predict.forward",
                  "sd.predict.decode"):
        (span,) = spans[child]
        assert inside(span, submit), child
    (fetch,) = spans["sd.predict.fetch"]
    (materialize,) = spans["sd.predict.materialize"]
    assert inside(fetch, collect) and inside(materialize, collect)
    assert fetch[1] <= materialize[0]


def test_gc_collections_are_spanned_and_counted():
    before = tracing.counters()
    _, spans, t0, t1 = traced(gc.collect)
    after = tracing.counters()
    assert set(after) == {"gen0", "gen1", "gen2"}
    assert after["gen2"]["collections"] >= before["gen2"]["collections"] + 1
    assert after["gen2"]["seconds"] > before["gen2"]["seconds"]
    assert after["gen2"]["collected"] >= before["gen2"]["collected"]
    assert spans["sd.gc.gen2"]
    assert_on_clock(spans, t0, t1)
    json.dumps(after)


class _Items:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"image": np.full((4, 4, 3), i, np.uint8)}


@pytest.mark.parametrize("route", ["inline", "threads", "batch_fetch"])
def test_loader_waits_and_copies_are_spanned(route):
    items = _Items()
    kw = {"inline": {}, "threads": {"num_workers": 2},
          "batch_fetch": {"batch_fetch": lambda idxs: {"image": np.stack(
              [items[i]["image"] for i in idxs])}}}[route]
    loader = Loader(items, batch_size=2, **kw)
    batches, spans, t0, t1 = traced(lambda: list(device_prefetch(loader, "cpu")))
    assert [b["image"].shape[0] for b in batches] == [2, 2, 2]
    assert_on_clock(spans, t0, t1)
    # one wait a batch, one for the epoch's order, one that finds the end
    # of a coordinator's queue
    assert len(spans["sd.loader.wait"]) >= 4
    assert len(spans["sd.loader.h2d"]) == 3


@pytest.fixture(scope="module")
def trainer_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_trainset")
    _write_images(root / "train", TRAIN_SIZES, seed=31, annotated=True)
    (root / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                  "parts": ["leaf"]}))
    return config_from_args([
        "--train_dir", str(root / "train"), "--valid_dir", str(root / "train"),
        "--labels", str(root / "labels.json"), "--anchor_name", "stem", "--width", "64",
        "--height", "64", "--fpn_depth", "16", "--max_objects", "4", "--max_parts", "8",
        "--no_amp", "--num_workers", "2", "--batch_size", "2", "--no_prewarm"])


def test_train_epoch_spans_the_loader_and_the_step_phases(trainer_config, tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(trainer_config, device="cpu", log=False)
    assert trainer.train_augmentation.device_augment
    _, spans, t0, t1 = traced(lambda: trainer.train_epoch(0))
    assert_on_clock(spans, t0, t1)
    steps = spans["sd.train.step"]
    assert len(steps) == len(trainer.train_loader) == len(TRAIN_SIZES) // 2
    for phase in STEP_PHASES:
        found = spans[phase]
        assert len(found) == len(steps), phase
        assert all(any(inside(p, s) for s in steps) for p in found), phase
    loop = steps[0][2]
    waits = spans["sd.loader.wait"]
    assert len(waits) > len(steps) and all(w[2] == loop for w in waits)
    assert not any(inside(w, s) for w in waits for s in steps)
    # only the spans that a benchmark metric reads (collections aside)
    assert {n for n in spans if not n.startswith("sd.gc.")} <= {
        "sd.train.step", *STEP_PHASES, "sd.loader.wait", "sd.loader.h2d"}


def test_train_epoch_calls_the_module_level_train_step(trainer_config, tmp_path,
                                                       monkeypatch):
    """The benchmark's check replaces `trainer.train_step` in the module and
    reads each step through it: the span around the call must not bind
    the function early."""
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(trainer_config, device="cpu", log=False)
    real, calls = trainer_mod.train_step, []

    def recording(state, *args, **kwargs):
        calls.append(state.step)
        return real(state, *args, **kwargs)

    monkeypatch.setattr(trainer_mod, "train_step", recording)
    _, spans, _, _ = traced(lambda: trainer.train_epoch(0))
    assert calls == list(range(len(trainer.train_loader)))
    assert len(spans["sd.train.step"]) == len(calls)
