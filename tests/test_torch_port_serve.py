"""The port's serving layer: `MicroBatcher` semantics with fake models,
and the HTTP server on a CPU `Predictor` answering POSTs with the same
annotations as `predict_batch`."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from structuredetector_tpu_torch.cli.serve import main as serve_main
from structuredetector_tpu_torch.predictor import Predictor
from structuredetector_tpu_torch.serve import (
    MicroBatcher,
    make_server,
    resolve_auto_max_batch,
    resolve_pipeline,
)
from tests.test_torch_port_model import port_config


class FakePredict:
    """Stands in for Predictor.predict_batch; records batch sizes."""

    def __init__(self, delay_s=0.0, fail=False):
        self.calls = []
        self.delay_s = delay_s
        self.fail = fail

    def __call__(self, images):
        self.calls.append(len(images))
        if self.fail:
            raise RuntimeError("model exploded")
        time.sleep(self.delay_s)
        return [f"ann-{im}" for im in images]


def _run_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_microbatcher_groups_and_pads_to_pow2():
    fake = FakePredict(delay_s=0.01)
    b = MicroBatcher(fake, max_batch=8, window_ms=100.0)
    results = [None] * 6

    def work(i):
        results[i] = b.submit(i)

    _run_threads(work, 6)
    assert results == [f"ann-{i}" for i in range(6)]
    assert b.images_run == 6 and b.batches_run < 6
    assert all(n in (1, 2, 4, 8) for n in fake.calls)
    stats = b.latency_stats()
    assert stats["count"] == 6 and stats["p50_ms"] <= stats["p99_ms"]
    b.close()


def test_microbatcher_errors_close_and_timeout():
    b = MicroBatcher(FakePredict(fail=True), max_batch=2, window_ms=1.0)
    with pytest.raises(RuntimeError, match="model exploded"):
        b.submit(0)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(0)
    with pytest.raises(ValueError):
        MicroBatcher(FakePredict(), max_batch=0)

    release = threading.Event()
    hung = MicroBatcher(lambda images: release.wait(10) and ["late"] * len(images),
                        max_batch=2, window_ms=1.0, submit_timeout_s=0.1)
    with pytest.raises(TimeoutError, match="submit timeout"):
        hung.submit(0)
    release.set()
    hung.close()


class FakeSplit:
    """Records the interleaving of pipelined submits and collects."""

    def __init__(self):
        self.events = []
        self.release_first = threading.Event()

    def submit(self, images):
        self.events.append(("submit", len(images)))
        if len(self.events) == 1:
            self.release_first.wait(timeout=5)
        return [f"r-{im}" for im in images]

    def collect(self, handle):
        self.events.append(("collect", len(handle)))
        return handle


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def test_pipelined_early_submit_of_a_full_batch():
    fake = FakeSplit()
    b = MicroBatcher(None, max_batch=1, window_ms=1.0,
                     predict_split=(fake.submit, fake.collect))
    results = {}
    t1 = threading.Thread(target=lambda: results.update(a=b.submit("a")))
    t1.start()
    _wait_for(lambda: fake.events)
    t2 = threading.Thread(target=lambda: results.update(b=b.submit("b")))
    t2.start()
    _wait_for(lambda: b.queue_depth == 1)
    fake.release_first.set()
    t1.join(5)
    t2.join(5)
    # batch 2 went to the device before batch 1's results were fetched
    assert [k for k, _ in fake.events] == ["submit", "submit", "collect", "collect"]
    assert results == {"a": "r-a", "b": "r-b"}
    b.close()


def test_pipelined_guard_does_not_count_the_shutdown_sentinel():
    """One live request plus the close() sentinel is not a full batch of
    two: the worker must collect the in-flight batch first instead of
    early-submitting a fragment (the JAX batcher counts the sentinel)."""
    fake = FakeSplit()
    b = MicroBatcher(None, max_batch=2, window_ms=1.0,
                     predict_split=(fake.submit, fake.collect))
    results = {}
    t1 = threading.Thread(target=lambda: results.update(a=b.submit("a")))
    t1.start()
    _wait_for(lambda: fake.events)  # batch 1 is inside submit
    t2 = threading.Thread(target=lambda: results.update(b=b.submit("b")))
    t2.start()
    _wait_for(lambda: b._queue.qsize() == 1)
    closer = threading.Thread(target=b.close)
    closer.start()
    _wait_for(lambda: b._queue.qsize() == 2)  # request + sentinel queued
    assert b.queue_depth == 1
    fake.release_first.set()
    for t in (t1, t2, closer):
        t.join(5)
        assert not t.is_alive()
    assert [k for k, _ in fake.events] == ["submit", "collect", "submit", "collect"]
    assert results == {"a": "r-a", "b": "r-b"}


def test_auto_max_batch_from_measurements():
    # 0.79 MB an image at 0.1 ms of device time needs 7.9 GB/s
    assert resolve_auto_max_batch(10_000.0, 0.1) == 128
    assert resolve_auto_max_batch(5_000.0, 0.1) == 32
    assert resolve_pipeline(10_000.0, 0.1) and not resolve_pipeline(5_000.0, 0.1)


def test_cli_needs_a_model_and_measures_only_on_cuda(tiny_config, tmp_path):
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    flags = ["--device", "cpu", "--width", "64", "--height", "64",
             "--fpn_depth", "32", "--labels", str(labels)]
    with pytest.raises(SystemExit, match="No model"):
        serve_main(flags)
    pth = tmp_path / "m.pth"
    torch.save(Predictor(port_config(tiny_config), device="cpu").model.state_dict(), pth)
    with pytest.raises(SystemExit, match="measure the card"):
        serve_main(flags + ["--load_model", str(pth)])


def _flatten(answer):
    """An answer JSON -> (structure, numbers): labels and keypoint kinds
    exactly; locations and scores as one float vector."""
    structure = [answer["img_size"]] + [
        (o["label"], [p["kind"] for p in o["parts"]]) for o in answer["objects"]
    ]
    numbers = [v for o in answer["objects"] for p in o["parts"]
               for v in (p["location"]["x"], p["location"]["y"], p["score"])]
    return structure, np.asarray(numbers, np.float64)


def assert_same_answer(got, want):
    """Batch composition changes the CPU convolution's summation order,
    so numbers compare at float32 round-off (rtol 1e-4)."""
    want = want.json_repr()
    want["image_path"] = "upload"
    assert got["image_path"] == want["image_path"]
    (gs, gn), (ws, wn) = _flatten(got), _flatten(want)
    assert gs == ws
    np.testing.assert_allclose(gn, wn, rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------ HTTP

@pytest.fixture(scope="module")
def predictor(tiny_config):
    return Predictor(port_config(tiny_config, conf_threshold=0.3), device="cpu")


@pytest.fixture(scope="module")
def server(predictor):
    srv, batcher = make_server(predictor, "127.0.0.1", 0, max_batch=4, window_ms=20.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", batcher
    srv.shutdown()
    srv.server_close()
    batcher.close()
    thread.join(timeout=10)


def _png(seed: int, size) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, path="/detect"):
    req = urllib.request.Request(url + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_answers_equal_predict_batch(server, predictor):
    url, batcher = server
    sizes = [(96, 80), (64, 64), (70, 100), (128, 96), (64, 80), (90, 90)]
    bodies = [_png(i, s) for i, s in enumerate(sizes)]
    answers = [None] * len(bodies)

    def post(i):
        answers[i] = _post(url, bodies[i])

    _run_threads(post, len(bodies))
    images = [Image.open(io.BytesIO(b)).convert("RGB") for b in bodies]
    want = predictor.predict_batch(images)
    for (status, got), w, size in zip(answers, want, sizes):
        assert status == 200
        assert_same_answer(got, w)
        assert got["img_size"] == list(size)
    assert sum(len(a[1]["objects"]) for a in answers) > 0

    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["images_run"] >= len(bodies)
    assert health["model"]["device"] == "cpu"
    assert set(health["gc"]) == {"gen0", "gen1", "gen2"}
    for gen in health["gc"].values():
        assert gen["collections"] >= 0 and gen["seconds"] >= 0


def test_http_rejects_bad_requests(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, b"not an image")
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, _png(0, (64, 64)), path="/nope")
    assert err.value.code == 404


def test_pipelined_server_answers_like_predict_batch(predictor):
    """The depth-2 pipeline drives predict_batch_submit/collect; its
    answers equal the synchronous predict_batch's."""
    srv, batcher = make_server(predictor, "127.0.0.1", 0, max_batch=2, window_ms=5.0,
                               pipeline=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        bodies = [_png(10 + i, (72, 64)) for i in range(5)]
        answers = [None] * len(bodies)

        def post(i):
            answers[i] = _post(url, bodies[i])[1]

        _run_threads(post, len(bodies))
        want = predictor.predict_batch([Image.open(io.BytesIO(b)).convert("RGB")
                                        for b in bodies])
        for got, w in zip(answers, want):
            assert_same_answer(got, w)
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        thread.join(timeout=10)
