"""Inference server with dynamic micro-batching.

The port of `structuredetector_tpu/serve.py`. HTTP clients send one
image at a time, while the device serves a batch far faster per image.
`MicroBatcher` closes the gap: requests queue up, a worker drains up to
`max_batch` of them (waiting at most `window_ms` after the first
arrival), and one forward + decode serves the whole group. Batches pad
to the next power of two, so only log2(max_batch)+1 shapes ever run.

The HTTP layer is stdlib (`ThreadingHTTPServer`): one POST per image,
the annotation JSON back in the reference's public schema. A request's
bytes decode in its handler thread, through the native library
(`data/native.py`: decode and resize in C++ with the GIL released,
byte-equal to PIL) when it is built, else with PIL; `/healthz` says
which (`model.native_decode`).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import tracing
from .data import native
from .predictor import PreparedImage

__all__ = ["MicroBatcher", "make_request_decoder", "make_server", "run_server"]

_SHUTDOWN = object()

# Reject request bodies above this before reading them: ThreadingHTTPServer
# spawns a thread per connection, so an unbounded client-declared
# Content-Length would let concurrent uploads exhaust host memory.
MAX_BODY_BYTES = 32 << 20


def probe_h2d_mbps(device, size_mb: float = 16.0) -> float:
    """Steady-state host->device copy rate in MB/s from pinned memory
    (the predictor's feed path), best of three."""
    buf = torch.zeros(int(size_mb * 2**20), dtype=torch.uint8).pin_memory()
    best = float("inf")
    for _ in range(4):  # the first copy warms the allocator up
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        buf.to(device, non_blocking=True)
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return size_mb / best


def measure_device_ms_per_img(predictor, batch: int = 32) -> float:
    """Device milliseconds per image of one warm forward + decode at
    `batch`, timed with CUDA events."""
    w, h = predictor.config.width, predictor.config.height
    dtype = np.uint8 if predictor.feed_uint8 else np.float32
    feed = predictor.to_device([np.zeros((h, w, 3), dtype)] * batch)
    predictor.decode(predictor.forward(feed))  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    predictor.decode(predictor.forward(feed))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / batch


def resolve_auto_max_batch(h2d_mbps: float, device_ms_per_img: float,
                           img_mb: float = 0.79) -> int:
    """128 when copying one more image (`img_mb`, 0.79 MB of uint8 at
    512x512) takes less time than computing it on the device, else 32.
    Both figures are measured on the serving card at startup."""
    need_mbps = img_mb / (device_ms_per_img / 1e3)
    return 128 if h2d_mbps >= need_mbps else 32


def resolve_pipeline(h2d_mbps: float, device_ms_per_img: float) -> bool:
    """Whether the depth-2 pipeline pays: it overlaps batch N+1's copy
    with batch N's device work, which needs a link that moves an image
    faster than the device computes it."""
    return resolve_auto_max_batch(h2d_mbps, device_ms_per_img) == 128


def _pad_pow2(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


class MicroBatcher:
    """Groups concurrent single-image requests into device batches.

    `predict_batch` is `Predictor.predict_batch` (or any callable from a
    list of images to a list of annotations). Thread-safe `submit`; one
    worker thread owns the device.
    """

    def __init__(self, predict_batch, max_batch: int = 8,
                 window_ms: float = 5.0,
                 submit_timeout_s: Optional[float] = None,
                 predict_split: Optional[tuple] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._predict = predict_batch
        # a (submit, collect) pair enables the depth-2 pipeline: batch
        # N+1's host prep + device dispatch run before batch N's result
        # fetch (Predictor.predict_batch_submit)
        self._split = predict_split
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.submit_timeout_s = submit_timeout_s
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders submit() vs close()
        # device calls served, images served, and a sliding window of
        # per-request latencies (submit -> done) for /healthz
        self.batches_run = 0
        self.images_run = 0
        self._latencies: "deque[float]" = deque(maxlen=2048)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a device batch, not counting the
        shutdown sentinel (close() enqueues it when it sets _closed)."""
        return max(0, self._queue.qsize() - int(self._closed))

    def latency_stats(self) -> dict:
        """p50/p95/p99 over the last <= 2048 served requests, in ms:
        queue wait + batching window + device forward + decode;
        nearest-rank percentiles."""
        lats = sorted(list(self._latencies))  # snapshot: the worker appends
        if not lats:
            return {"count": 0}
        n = len(lats)

        def pct(p: float) -> float:
            return round(lats[min(n - 1, int(round(p * (n - 1))))] * 1e3, 3)

        return {"count": n, "p50_ms": pct(0.50), "p95_ms": pct(0.95),
                "p99_ms": pct(0.99)}

    def submit(self, image, timeout: Optional[float] = None):
        """Blocks until the batcher has a result; returns the annotation
        (or raises what the model raised). A `timeout` (seconds; default
        the constructor's `submit_timeout_s`, default unbounded) raises
        TimeoutError instead of wedging the calling thread."""
        done = threading.Event()
        slot: dict = {"t0": time.monotonic()}
        with self._lock:
            # a non-closed batcher enqueues BEFORE close() enqueues
            # _SHUTDOWN (FIFO), so the worker always services this item
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put((image, done, slot))
        if not done.wait(timeout if timeout is not None else self.submit_timeout_s):
            raise TimeoutError(
                f"inference did not complete within the submit timeout "
                f"({timeout or self.submit_timeout_s} s)"
            )
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SHUTDOWN)
        self._worker.join(timeout=5)
        if self._worker.is_alive():
            # the worker is wedged inside predict_batch: fail everything
            # still queued here (items it already took have timeouts)
            self._fail_queued("batcher shut down while the device worker was hung")

    def _fail_queued(self, message: str):
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            if leftover is _SHUTDOWN:
                continue
            _, done, slot = leftover
            slot["error"] = RuntimeError(message)
            done.set()

    def _gather_window(self, first) -> tuple:
        """(items, saw_shutdown): wait up to the batching window for
        more requests after the first arrival."""
        items = [first]
        deadline = time.monotonic() + self.window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                return items, True
            items.append(nxt)
        return items, False

    def _loop(self):
        if self._split is not None:
            self._loop_pipelined()
            return
        try:
            while True:
                first = self._queue.get()
                if first is _SHUTDOWN:
                    return
                items, saw_shutdown = self._gather_window(first)
                self._run(items)
                if saw_shutdown:
                    return
        finally:
            self._drain_on_exit()

    def _loop_pipelined(self):
        """Depth-2 pipeline over the (submit, collect) split: submit
        batch N+1 to the device BEFORE collecting batch N's results.

        The early submit happens only when a full `max_batch` of live
        requests is already queued; anything less would split the
        arrival stream across two in-flight batches and fragment both.
        Below saturation this behaves like the sync loop."""
        submit, collect = self._split
        pending = None  # (items, handle) in flight on the device
        nxt = None
        shutdown = False
        try:
            while True:
                items = []
                if pending is None:
                    first = self._queue.get()
                    if first is _SHUTDOWN:
                        return
                    items, shutdown = self._gather_window(first)
                elif self.queue_depth >= self.max_batch:
                    # a full batch of live requests is waiting: overlap
                    # it with the in-flight batch
                    while len(items) < self.max_batch:
                        try:
                            got = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if got is _SHUTDOWN:
                            shutdown = True
                            break
                        items.append(got)
                # else: a batch is in flight and fewer than max_batch
                # wait: collect first, then gather with the window

                nxt = None
                if items:
                    try:
                        nxt = (items, self._submit_batch(submit, items))
                    except BaseException as e:
                        self._fail_items(items, e)
                if pending is not None:
                    self._collect_batch(collect, pending)
                pending = nxt
                if shutdown:
                    if pending is not None:
                        self._collect_batch(collect, pending)
                    return
        finally:
            # an exception unwinding here can leave a batch in flight
            # whose items already left the queue: fail their waiters
            err = RuntimeError("batcher shut down while a batch was in flight")
            for inflight in (pending, nxt):
                if inflight is not None:
                    for _, done, slot in inflight[0]:
                        if not done.is_set():
                            slot["error"] = err
                            done.set()
            self._drain_on_exit()

    def _drain_on_exit(self):
        # via _SHUTDOWN or a worker crash, never leave a waiter blocked;
        # under the lock, so no submit() slips an item in meanwhile
        with self._lock:
            self._closed = True
            self._fail_queued("batcher shut down")

    def _fail_items(self, items, e: BaseException):
        """Surface a failure to every still-unserved waiter of a batch."""
        err = e if isinstance(e, Exception) else RuntimeError(repr(e))
        for _, done, slot in items:
            if not done.is_set():
                slot["error"] = err
                done.set()
        if not isinstance(e, Exception):
            raise  # KeyboardInterrupt/SystemExit still terminate

    def _padded(self, items):
        images = [im for im, _, _ in items]
        target = _pad_pow2(len(images), self.max_batch)
        return images + [images[-1]] * (target - len(images))

    def _submit_batch(self, submit, items):
        """Pipeline front half: pad and dispatch to the device."""
        return submit(self._padded(items))

    def _deliver(self, items, results):
        results = results[: len(items)]
        if len(results) < len(items):
            raise RuntimeError(
                f"predictor returned {len(results)} results for {len(items)} images"
            )
        self.batches_run += 1
        self.images_run += len(items)
        now = time.monotonic()
        for (_, done, slot), result in zip(items, results):
            slot["result"] = result
            self._latencies.append(now - slot["t0"])
            done.set()

    def _collect_batch(self, collect, pending):
        """Pipeline back half: fetch results and wake the waiters."""
        items, handle = pending
        try:
            self._deliver(items, collect(handle))
        except BaseException as e:
            self._fail_items(items, e)

    def _run(self, items):
        # padded results past the real requests are dropped
        try:
            self._deliver(items, self._predict(self._padded(items)))
        except BaseException as e:
            self._fail_items(items, e)


def decode_request(data: bytes):
    """Request bytes -> a loaded RGB PIL image, decoded NOW: a truncated
    payload must 400 here, not fail inside a shared micro-batch."""
    from PIL import Image

    image = Image.open(io.BytesIO(data))
    image.load()
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


def make_request_decoder(predictor, use_native: bool):
    """Request bytes -> the predictor's feed (JAX `serve.py:405-445`).

    With `use_native`, the native library decodes and resizes the payload
    into a `PreparedImage` of the predictor's feed, so the batch skips the
    per-image PIL transform; the three feeds, as `feed_uint8` and
    `feed_normalize` say:

    - uint8 RGB, normalized on the device (`Predictor(device_normalize=
      True)`, an `--uint8_input` artifact);
    - float32 ImageNet-normalized on the host;
    - neither (a float artifact exported with `--norm`, whose program
      owns /255 and mean/std): raw [0, 255] float32, decoded as uint8
      and widened (the library's float output is [0, 1]).

    Without it, `decode_request`: a loaded PIL image. Either way a bad
    payload raises here, in the request's own thread."""
    if not use_native:
        return decode_request
    cfg = predictor.config
    feed_u8, feed_norm = predictor.feed_uint8, predictor.feed_normalize

    def decode_native(data: bytes) -> PreparedImage:
        arr, size = native.decode_bytes(data, cfg.width, cfg.height, normalize=feed_norm,
                                        dtype=np.float32 if feed_norm else np.uint8)
        if not feed_u8 and not feed_norm:
            arr = arr.astype(np.float32)
        return PreparedImage(arr, size)

    return decode_native


def make_server(predictor, host: str = "127.0.0.1", port: int = 8000,
                max_batch: int = 8, window_ms: float = 5.0,
                submit_timeout_s: Optional[float] = 30.0,
                pipeline: bool = False):
    """(ThreadingHTTPServer, MicroBatcher) serving the predictor.

    Routes:
      POST /detect  — raw JPEG/PNG bytes in the body -> annotation JSON
                      (reference schema) in original image coordinates
      GET  /healthz — liveness + batching counters + queue depth + the
                      garbage collector's pauses (`tracing.counters()`)
    """
    split = None
    if pipeline:
        split = (predictor.predict_batch_submit, predictor.predict_batch_collect)
    batcher = MicroBatcher(predictor.predict_batch, max_batch=max_batch,
                           window_ms=window_ms,
                           submit_timeout_s=submit_timeout_s,
                           predict_split=split)
    cfg = predictor.config
    # the per-request PIL decode and resize held the JAX server far below
    # its device's rate (JAX serve.py:475-482): decode natively when the
    # library is built, else fall back to PIL, and say which
    use_native = native.supports_decode_bytes()
    decode = make_request_decoder(predictor, use_native)
    model_info = {
        "width": cfg.width, "height": cfg.height,
        "anchors": list(cfg.labels.keys()), "parts": list(cfg.parts.keys()),
        "anchor_name": cfg.anchor_name,
        "device": str(predictor.device),
        "native_decode": use_native,
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "batches_run": batcher.batches_run,
                    "images_run": batcher.images_run,
                    "queue_depth": batcher.queue_depth,
                    "latency": batcher.latency_stats(),
                    "gc": tracing.counters(),
                    "model": model_info,
                })
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/detect":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            raw_len = self.headers.get("Content-Length")
            if raw_len is None:
                self._reply(411, {"error": "Content-Length required"})
                return
            try:
                length = int(raw_len)
            except ValueError:
                self._reply(400, {"error": f"bad Content-Length: {raw_len!r}"})
                return
            if length <= 0:
                self._reply(400, {"error": "empty body"})
                return
            if length > MAX_BODY_BYTES:
                # refuse BEFORE reading: the declared size alone must not
                # let clients fill host memory
                self._reply(413, {
                    "error": f"body too large ({length} > {MAX_BODY_BYTES} bytes)"
                })
                return
            try:
                image = decode(self.rfile.read(length))
            except Exception as e:
                self._reply(400, {"error": f"bad image payload: {e}"})
                return
            try:
                annotation = batcher.submit(image)
            except TimeoutError as e:
                self._reply(503, {"error": str(e)})
                return
            except Exception as e:
                self._reply(500, {"error": str(e)})
                return
            payload = annotation.json_repr()
            # after serialization: json_repr resolves the path against
            # the cwd, which must not reach clients
            payload["image_path"] = "upload"
            self._reply(200, payload)

    class Server(ThreadingHTTPServer):
        # the stdlib accept backlog (5) resets concurrent clients
        request_queue_size = 128

    return Server((host, port), Handler), batcher


def run_server(predictor, host: str = "127.0.0.1", port: int = 8000,
               max_batch: int = 8, window_ms: float = 5.0,
               ready: Optional[threading.Event] = None,
               submit_timeout_s: Optional[float] = 30.0,
               pipeline: bool = False):
    """Serve until interrupted; `ready` is set once the socket listens."""
    server, batcher = make_server(predictor, host, port, max_batch, window_ms,
                                  submit_timeout_s=submit_timeout_s,
                                  pipeline=pipeline)
    if ready is not None:
        ready.set()
    try:
        server.serve_forever()
    finally:
        batcher.close()
        server.server_close()
