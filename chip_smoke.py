#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`structuredetector_tpu_torch`).

    python3 chip_smoke.py [--load_model model.pth|model.msgpack] [--parent DIR]

Runs on one NVIDIA GPU from the root of a checkout and imports nothing
of JAX or of the JAX package. Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel from csrc/ (nvcc, sm_90a, one process
   per source, in parallel);
3. kernels: holds each kernel (A sigmoid_nms, B sigmoid_nms_topk, C
   sigmoid_nms_topk_rowmax) bit-exact against its plain PyTorch version
   at the main paths' shapes and on the tiling's edge cases (ragged
   tiles, a plateau across tile borders, k above a tile's pixels,
   256x256, more than 32 tiles, 1x1, a saturated background, thin
   planes 1x4096, 4096x1 and 65536x1), and times kernel, plain version
   and yardstick with CUDA events, kernels B and C on random and on
   saturated-background planes: kernel B also by phase (tile selection,
   merge, the gap between them; from a torch.profiler trace), t(k) for
   k = 1, 20, 40 and from it kernel C's cost a round, kernel C's cluster
   occupancy (cudaOccupancyMaxActiveClusters) at the serving shapes,
   each kernel's share of its bound, and the SM clock and power of the
   timed card sampled beside the window;
   with `--parent DIR` (a checkout of another commit), also that
   checkout's kernels A, B and C, called through its own public
   wrappers, against these, in turns (old, new, new, old);
4. serve (main path of kernels A and B): a full-width SDNet (resnet34,
   fpn_depth 128, 512x512, bf16, labels.json) behind the port's
   micro-batching HTTP server answers concurrent PNG POSTs; the Decoder
   path (kernel A) and the serving decode (kernel B) must give identical
   detections from one forward, and both kernels' launch counters must
   rise. Then it times batch-32 throughput and the request latency;
5. topk_variants (main path of kernel C): the port's variant shootout
   (`tools/bench_topk_variants.py`) at batch 128, both variants
   bit-exact first;
6. evaluate_detect (main path of kernels A and B): the same full-width
   model, written as a .msgpack by the port, runs `cli.detect` over 64
   PNGs of mixed sizes at `--eval_batch_size 32` (kernel B), then
   `cli.evaluate` on detect's own predictions with `--conf_sweep`
   (kernel A); anchor F1 must be at least 0.99 for every label, the
   sweep's first summary must equal a run without the sweep, and both
   kernels' launch counters must rise. Reports images/s of both;
7. reference: a small fp32 model on the card agrees with the same model
   on the CPU;
8. train (main path of kernel A): the train step at full width (bf16,
   device augmentation, uint8 feed, every keypoint slot filled) timed at
   batch 8 and 32 with CUDA events (ms, img/s, peak memory, finite loss,
   its FLOPs' share of the dense bf16 peak); 30 steps on one batch must
   cut the loss below 0.7 of the first; `cli.train` for 2 epochs on 64
   annotated PNGs (16 to validate, kernel A's counter must rise), then
   `cli.evaluate` on the `model_best_loss.msgpack` it wrote; one fp32
   step of a small model on the card against the CPU (loss within 1e-4
   relative, gradients within the bars stated there).

Each main path is driven with the launch counts set to 0 just before it
and read just after. Then the `{"kernels": [...]}` line, the nvidia-smi
line, and last `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero; without CUDA, or without the package beside this file,
it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations a pixel of the sigmoid + plateau NMS front: sigmoid 4 (neg,
# exp, add, div), clamp 2, 24 maxima of the 5x5 window, 1 equality select
FRONT_OPS_PER_PIXEL = 31
# kernel B adds a linear-time selection: one comparison a pixel
SELECT_OPS_PER_PIXEL = 1
# dense bf16 tensor-core peak of the same data sheet, for the train step
BF16_DENSE_OPS_PER_S = 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of `fn()`, free of host launch overhead
    (`tools.timing.device_ms`)."""
    from structuredetector_tpu_torch.tools.timing import device_ms

    return device_ms(fn, iters=iters, warmup=warmup)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# ----------------------------------------------------------------------
def phase_build():
    from structuredetector_tpu_torch.ops.kernels import _build

    seconds = _build.build_all()
    report = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
              for name, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "ptxas": report})


def _pci_bus_id() -> str:
    """The PCI bus id of the current CUDA device, as `nvidia-smi -i` takes
    it (the device index would name another card under
    CUDA_VISIBLE_DEVICES)."""
    import torch

    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:{props.pci_device_id:02X}.0"


@contextlib.contextmanager
def sampled_clocks(into: dict):
    """Sample the SM clock and power of the current CUDA device every
    100 ms while the block runs (`nvidia-smi --query-gpu=clocks.sm,
    power.draw,power.limit --format=csv`); on exit write their min /
    median / max and the card's bus id into `into`."""
    import subprocess

    bus_id = _pci_bus_id()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-i", bus_id, "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue  # a line cut by the terminate, or "[N/A]"
    for i, name in enumerate(("sm_clock_mhz", "power_draw_w", "power_limit_w")):
        vals = sorted(r[i] for r in rows if len(r) == 3)
        into[name] = [vals[0], vals[len(vals) // 2], vals[-1]] if vals else None
    into["samples"] = len(rows)
    into["pci_bus_id"] = bus_id
    into["format"] = "[min, median, max] over samples every 100 ms"


def saturated(rng, n: int, h: int = 128, w: int = 128, peaks: int = 4):
    """(n, h, w) logits of a background a trained head has saturated: -20
    everywhere, where the clamped sigmoid is 1e-6, a plateau on which
    every pixel is the max of its window, with `peaks` 3x3 bumps a plane.
    Kernel B's select takes its plateau path on every tile of such a
    plane, where random planes take the path for few keys in play."""
    import numpy as np
    import torch

    x = np.full((n, h, w), -20.0, np.float32)
    for plane in x:
        for _ in range(peaks):
            y, c = rng.integers(1, h - 1), rng.integers(1, w - 1)
            plane[y - 1:y + 2, c - 1:c + 2] = rng.uniform(-4.0, 4.0)
            plane[y, c] += 1.0
    return torch.from_numpy(x).cuda()


def kernel_trace(fn, first: str, second: str, iters: int = 50) -> dict:
    """Kernel B's phases in a torch.profiler (CUPTI) trace of `iters`
    calls of `fn`: per call of `fn`, the device ms of the kernels whose
    name holds `first` and of those that hold `second`, and the idle ms
    from the end of each `first` launch to the start of the `second`
    launch after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a ~50 ms spin first, so every call is queued before the card
        # reaches it: the gaps are the card's, not the traced host's
        torch.cuda._sleep(100_000_000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and (first in e.name or second in e.name)),
                    key=lambda e: e.time_range.start)
    out = {}
    for key, name in (("phase1_tiles", first), ("phase2_merge", second)):
        out[key] = sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3 / iters
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(events, events[1:])
            if first in a.name and second in b.name]
    if not out["phase1_tiles"] or not out["phase2_merge"] or not gaps:
        raise AssertionError(f"the profiler saw no device time of {first} / {second}")
    out["gap_ms"] = sum(gaps) / 1e3 / iters
    out["format"] = f"device ms a call from a torch.profiler trace of {iters} calls"
    return out


def edge_cases(rng):
    """(planes, k) where the 32-wide, 64-tall tiling of kernels A, B and C
    has edges to get wrong: ragged tiles, a plateau across a tile border, k
    above a tile's pixels on a plane with one peak, a 256x256 plane and one
    of more than 32 tiles, a 1x1 plane with k = 1, and thin planes, on
    which a layout sized by rows or by whole tiles breaks (33x65 and 1x1
    also leave some of kernel C's cluster without a tile)."""
    import numpy as np
    import torch

    def logits(*shape):
        return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()

    border = logits(2, 128, 128)
    border[:, 60:68, 28:36] = 20.0  # clamps to 1 - 1e-6: one plateau over 4 tiles
    yy, xx = np.mgrid[0:128, 0:128]
    cone = (5.0 - np.hypot(yy - 70, xx - 40) / 20.0).astype(np.float32)
    return {"ragged 33x65": (logits(3, 33, 65), 9), "ragged 40x72": (logits(3, 40, 72), 9),
            "plateau across tile borders": (border, 40),
            "k=2100 > tile pixels, one peak": (torch.from_numpy(np.stack([cone, cone.T])).cuda(),
                                               2100),
            "256x256, 32 tiles": (logits(4, 256, 256), 40),
            "65x1008, 64 tiles": (logits(2, 65, 1008), 40),
            "1x1, k=1": (logits(3, 1, 1), 1),
            "thin 1x4096": (logits(2, 1, 4096), 40), "thin 4096x1": (logits(2, 4096, 1), 40),
            "thin 65536x1": (logits(1, 65536, 1), 40)}


def phase_kernels(card: str) -> dict:
    """Bit-exactness and timings; returns the per-kernel measurements."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.ops.kernels import (
        sigmoid_nms,
        sigmoid_nms_reference,
        sigmoid_nms_topk,
        sigmoid_nms_topk_reference,
    )
    from structuredetector_tpu_torch.ops.kernels._build import load

    rng = np.random.default_rng(926354916)

    def logits(*shape):
        return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()

    # kernels B ("rounds") and C ("onehot"): serving shapes (anchors 2 x 32,
    # parts 32) on random and on saturated-background planes, a plane count
    # not a multiple of 8, an all-equal plane, non-square planes, a 256x256
    # plane, k = H * W (every row spent), and the tiling's edge cases
    sat_a, sat_p = saturated(rng, 64), saturated(rng, 32)
    cases = {"anchors 64x128x128": (logits(64, 128, 128), 20),
             "parts 32x128x128": (logits(32, 128, 128), 40),
             "saturated anchors 64x128x128": (sat_a, 20),
             "saturated parts 32x128x128": (sat_p, 40),
             "100 planes": (logits(100, 128, 128), 20),
             "all-equal": (torch.zeros((2, 128, 128), device="cuda"), 40),
             "40x72 k=H*W": (logits(2, 40, 72), 40 * 72), **edge_cases(rng)}

    # kernel A: (32, 3, 128, 128), the two serving shapes, and every
    # top-k case's planes
    err_a = 0.0
    a_inputs = [logits(*shape) for shape in ((32, 3, 128, 128), (32, 2, 128, 128),
                                             (32, 1, 128, 128), (3, 2, 40, 72))]
    for x in a_inputs + [planes.unsqueeze(1) for planes, _ in cases.values()]:
        got, want = sigmoid_nms(x), sigmoid_nms_reference(x)
        err_a = max(err_a, max_abs_diff(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"sigmoid_nms differs from its plain version at "
                                 f"{tuple(x.shape)}")

    err = {"rounds": 0.0, "onehot": 0.0}
    for name, (planes, k) in cases.items():
        want = sigmoid_nms_topk_reference(planes, k)
        for variant in err:
            got = sigmoid_nms_topk(planes, k, variant=variant)
            for g, w in zip(got, want):
                err[variant] = max(err[variant], max_abs_diff(g, w))
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"sigmoid_nms_topk ({variant}) differs from its plain version on "
                        f"{name} {tuple(planes.shape)}, k={k}")
    for variant in err:
        flat_inds = sigmoid_nms_topk(cases["all-equal"][0], 40, variant=variant)[1]
        if flat_inds.cpu().tolist() != [list(range(40))] * 2:
            raise AssertionError(
                f"all-equal plane ({variant}): ties must go to ascending flat index")

    # timings at the main path's per-batch work (batch 32, 128x128 grid):
    # kernel A runs on anchors (32, 2) and parts (32, 1); kernels B and C
    # on the 64 anchor planes (k=20) and the 32 part planes (k=40)
    anchors, parts = logits(32, 2, 128, 128), logits(32, 1, 128, 128)
    a_planes, p_planes = anchors.reshape(64, 128, 128), parts.reshape(32, 128, 128)
    pixels = anchors.numel() + parts.numel()
    clocks = {}
    with sampled_clocks(clocks):
        a_ms = time_ms(lambda: (sigmoid_nms(anchors), sigmoid_nms(parts)))
        a_plain = time_ms(lambda: (sigmoid_nms_reference(anchors),
                                   sigmoid_nms_reference(parts)))
        # a plain copy of the bytes kernel A moves: the practical floor of a
        # bytes-bound kernel at this size (not the same function)
        a_out, p_out = torch.empty_like(anchors), torch.empty_like(parts)
        a_copy = time_ms(lambda: (a_out.copy_(anchors), p_out.copy_(parts)))
        topk_plain = time_ms(lambda: (sigmoid_nms_topk_reference(a_planes, 20),
                                      sigmoid_nms_topk_reference(p_planes, 40)))
        sup_a = sigmoid_nms_reference(a_planes).reshape(64, -1)
        sup_p = sigmoid_nms_reference(p_planes).reshape(32, -1)
        topk_partial = time_ms(lambda: (torch.topk(sup_a, 20), torch.topk(sup_p, 40)))
        # kernels B and C on random and on saturated-background planes, in
        # turns: B, C, C, B
        traffic = {"random": (a_planes, p_planes), "saturated": (sat_a, sat_p)}
        topk = {(v, t): [] for v in ("rounds", "onehot") for t in traffic}
        for t, (xa, xp) in traffic.items():
            for variant in ("rounds", "onehot", "onehot", "rounds"):
                topk[variant, t].append(time_ms(lambda v=variant, xa=xa, xp=xp: (
                    sigmoid_nms_topk(xa, 20, variant=v), sigmoid_nms_topk(xp, 40, variant=v))))
        # t(k) on the anchor planes
        by_k = {v: {k: time_ms(lambda k=k, v=v: sigmoid_nms_topk(a_planes, k, variant=v))
                    for k in (1, 20, 40)} for v in ("rounds", "onehot")}
        # kernel B's two phases apart: phase 1 (tiled front + tile
        # selection), phase 2 (merge), from the profiler's kernel times
        split = {t: kernel_trace(lambda xa=xa, xp=xp: (sigmoid_nms_topk(xa, 20),
                                                       sigmoid_nms_topk(xp, 40)),
                                 "topk_tiles_kernel", "topk_merge_kernel")
                 for t, (xa, xp) in traffic.items()}
        for t in traffic:
            split[t]["both_events_ms"] = sum(topk["rounds", t]) / 2
        # the device time of a near-empty kernel (a spin of 0 cycles): the
        # floor under each launch above
        empty_ms = time_ms(lambda: torch.cuda._sleep(0))

    a_bound, a_by = bound_ms(2 * 4 * pixels, FRONT_OPS_PER_PIXEL * pixels)
    # B and C compute one function: one bound, one plain version, one
    # partial yardstick (torch.topk over the already suppressed planes,
    # selection only; no single PyTorch call computes the whole function)
    out_bytes = (64 * 20 + 32 * 40) * 8
    topk_bound, topk_by = bound_ms(4 * pixels + out_bytes,
                                   (FRONT_OPS_PER_PIXEL + SELECT_OPS_PER_PIXEL) * pixels)

    def topk_entry(variant):
        ms = sum(topk[variant, "random"]) / 2
        sat_ms = sum(topk[variant, "saturated"]) / 2
        return {"max_abs_err": err[variant], "ms": ms, "ms_runs": topk[variant, "random"],
                "plain_ms": topk_plain, "bound_ms": topk_bound, "bound_by": topk_by,
                "bound_share": topk_bound / ms, "library_ms": None,
                "topk_partial_ms": topk_partial, "ms_by_k_64_planes": by_k[variant],
                "saturated_ms": sat_ms, "saturated_ms_runs": topk[variant, "saturated"],
                "saturated_bound_share": topk_bound / sat_ms}

    # kernel C: the cost of a round from t(k) on the 64 anchor planes, and
    # the clusters of 8 blocks the card holds at once at the serving shapes
    c_by_k = by_k["onehot"]
    us_per_round = (c_by_k[40] - c_by_k[1]) / 39 * 1e3
    clusters = {f"{n}x128x128": load("sigmoid_nms_topk_rowmax").sdnet_rowmax_active_clusters(
        n, 128, 128) for n in (64, 32)}
    if min(clusters.values()) < 1:
        raise AssertionError(f"cudaOccupancyMaxActiveClusters failed: {clusters}")

    result = {
        "sigmoid_nms": {"max_abs_err": err_a, "ms": a_ms, "plain_ms": a_plain,
                        "bound_ms": a_bound, "bound_by": a_by, "bound_share": a_bound / a_ms,
                        "library_ms": None, "copy_same_bytes_ms": a_copy},
        "sigmoid_nms_topk": {**topk_entry("rounds"), "phases_ms": split},
        "sigmoid_nms_topk_rowmax": {**topk_entry("onehot"), "us_per_round": us_per_round,
                                    "active_clusters": clusters},
    }
    emit({"phase": "kernels", "card": card, "bit_exact": True, "cases": list(cases),
          "timed_work": "one served batch of 32 at 512x512: anchors (32,2,128,128) + "
                        "parts (32,1,128,128), N(0, 3) logits; saturated_*: the same "
                        "shapes at -20 with 4 peaks a plane; warm L2, CUDA events, "
                        "mean of 50",
          "topk_partial_ms_is": "torch.topk over the suppressed planes only (partial)",
          "empty_kernel_ms": empty_ms, "clocks": clocks, **result})
    return result


def _import_checkout(parent: Path):
    """The kernels module of another checkout's port package, imported
    under a name of its own. The package's modules import one another
    relatively, so its kernels build from its own csrc/ into its own
    _build/ and count their own launches."""
    import importlib
    import importlib.util

    name = "sdnet_parent"
    pkg = parent / "structuredetector_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.kernels")


def phase_parent(card: str, parent: Path) -> dict:
    """Kernels A, B and C of another checkout (the parent commit), built
    from its csrc/ and called through its public wrappers `sigmoid_nms`
    and `sigmoid_nms_topk` (C as `variant="onehot"`), against this
    checkout's, in turns (old, new, new, old) at the batch-32 work: A on
    random logits, B and C on random and on saturated-background planes.
    Both must give the same outputs."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.ops import kernels as new

    old = _import_checkout(parent)
    rng = np.random.default_rng(926354916)
    anchors, parts = (torch.from_numpy(rng.normal(0, 3, (32, c, 128, 128)).astype(np.float32))
                      .cuda() for c in (2, 1))
    traffic = {"random": (anchors.reshape(64, 128, 128), parts.reshape(32, 128, 128)),
               "saturated": (saturated(rng, 64), saturated(rng, 32))}

    for x in (anchors, parts):
        if not torch.equal(old.sigmoid_nms(x), new.sigmoid_nms(x)):
            raise AssertionError("the parent's kernel A and this one disagree")
    variants = {"B": "rounds", "C": "onehot"}
    for xa, xp in traffic.values():
        for x, k in ((xa, 20), (xp, 40)):
            for kernel, variant in variants.items():
                got = zip(old.sigmoid_nms_topk(x, k, variant=variant),
                          new.sigmoid_nms_topk(x, k, variant=variant))
                if not all(torch.equal(o, n) for o, n in got):
                    raise AssertionError(f"the parent's kernel {kernel} and this one disagree")

    def topk(mod, t, variant):
        xa, xp = traffic[t]
        return lambda: (mod.sigmoid_nms_topk(xa, 20, variant=variant),
                        mod.sigmoid_nms_topk(xp, 40, variant=variant))

    work = {"A": {"old": lambda: (old.sigmoid_nms(anchors), old.sigmoid_nms(parts)),
                  "new": lambda: (new.sigmoid_nms(anchors), new.sigmoid_nms(parts))}}
    for kernel, variant in variants.items():
        for t in traffic:
            work[f"{kernel} {t}"] = {"old": topk(old, t, variant), "new": topk(new, t, variant)}
    result, clocks = {}, {}
    with sampled_clocks(clocks):
        for kernel, fns in work.items():
            runs = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                runs[which].append(time_ms(fns[which]))
            result[kernel] = {**runs, "old_ms": sum(runs["old"]) / 2,
                              "new_ms": sum(runs["new"]) / 2}
    emit({"phase": "parent", "card": card, "parent": str(parent),
          "timed_work": "batch-32 work as in the kernels phase, in turns old, new, new, old",
          "clocks": clocks, **result})
    return result


def _png(rng, w: int, h: int) -> bytes:
    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST /detect answered {resp.status}")
        return json.loads(resp.read())


def phase_serve(card: str, load_model) -> dict:
    """The main path; returns the launch counts of its run."""
    import numpy as np
    import torch
    from PIL import Image

    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.ops.decode import (
        decode_feature_maps,
        decode_feature_maps_planes,
        split_head_output,
    )
    from structuredetector_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
        sigmoid_nms,
    )
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage
    from structuredetector_tpu_torch.serve import make_server, measure_device_ms_per_img

    cfg = Config(labels_path=ROOT / "labels.json", pretrained_model=load_model).finalize()
    t0 = time.perf_counter()
    fast = Predictor(cfg, device="cuda")
    slow = Predictor(cfg, device="cuda", fast_path=False)
    slow.model.load_state_dict(fast.model.state_dict())
    setup_s = time.perf_counter() - t0
    if not fast.fast_path or slow.fast_path:
        raise AssertionError("fast path must default on for CUDA")

    rng = np.random.default_rng(926354916)
    sizes = [(640, 480), (512, 512), (800, 600), (333, 517)]
    bodies = [_png(rng, *sizes[i % len(sizes)]) for i in range(32)]
    feed = [PreparedImage(rng.integers(0, 256, (cfg.height, cfg.width, 3), np.uint8),
                          (cfg.width, cfg.height)) for _ in range(32)]
    for b in (1, 2, 4, 8, 16, 32):  # the shapes the batcher pads to
        fast.predict_batch(feed[:b])
        slow.predict_batch(feed[:b])
    torch.cuda.synchronize()

    # --- the main path: counts set to 0 just before, read just after
    reset_launch_counts()
    server, batcher = make_server(fast, "127.0.0.1", 0, max_batch=32, window_ms=20.0,
                                  submit_timeout_s=120.0)
    port = server.server_address[1]
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    answers = [None] * len(bodies)

    def client(c: int):
        for i in range(c, len(bodies), 4):
            answers[i] = _post(f"http://127.0.0.1:{port}/detect", bodies[i])

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    http_s = time.perf_counter() - t0
    latency = batcher.latency_stats()
    batches, served = batcher.batches_run, batcher.images_run
    server.shutdown()
    server.server_close()
    batcher.close()
    server_thread.join(timeout=30)
    if any(t.is_alive() for t in clients) or server_thread.is_alive():
        raise AssertionError("a client or the server thread did not finish")
    if None in answers or served != len(bodies):
        raise AssertionError(f"served {served} of {len(bodies)} requests")

    # every answer is an annotation of its own image, in the schema
    for body, ans in zip(bodies, answers):
        with Image.open(io.BytesIO(body)) as im:
            size = list(im.size)
        if ans["img_size"] != size:
            raise AssertionError(f"answer for a {size} image says {ans['img_size']}")
        for obj in ans["objects"]:
            kinds = {p["kind"] for p in obj["parts"]}
            if obj["label"] not in cfg.labels or not kinds <= {cfg.anchor_name, *cfg.parts}:
                raise AssertionError(f"malformed object in an answer: {obj}")
    if batches >= len(bodies):
        raise AssertionError("the micro-batcher formed no batch larger than 1")

    # the Decoder path (kernel A) and the fast path (kernel B) on one batch
    anns_fast = [a.json_repr() for a in fast.predict_batch(feed)]
    anns_slow = [a.json_repr() for a in slow.predict_batch(feed)]
    if anns_fast != anns_slow:
        raise AssertionError("Predictor(fast_path=False) and the fast path disagree")
    torch.cuda.synchronize()
    launches = launch_counts()
    if not launches["sigmoid_nms"] or not launches["sigmoid_nms_topk"]:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    # --- end of the main path

    # one head output through every decode: the Decoder path, the plain
    # front, the kernel-A front and the plane decode equal the fast path
    with torch.inference_mode():
        head = fast.forward(fast.to_device([f.array for f in feed]))
        dec_b = fast.decode(head, fast_path=True)
        outputs = split_head_output(head, cfg.n_labels, cfg.n_parts)
        kw = dict(max_objects=cfg.max_objects, max_parts=cfg.max_parts,
                  conf_thresh=cfg.conf_threshold, dist_thresh=cfg.decoder_dist_thresh)
        others = {"Decoder path": fast.decode(head, fast_path=False),
                  "kernel A front": decode_feature_maps(outputs, nms_fn=sigmoid_nms, **kw),
                  "plain front": decode_feature_maps(outputs, **kw),
                  "plane decode": decode_feature_maps_planes(outputs, **kw)}
    for key in dec_b:
        for name, other in others.items():
            if not torch.equal(dec_b[key], other[key]):
                raise AssertionError(f"{name} differs from the fast path on {key}")
    if not torch.isfinite(head).all() or tuple(head.shape) != (32, cfg.out_channels, 128, 128):
        raise AssertionError(f"bad head output {tuple(head.shape)}")

    # bf16 against fp32 (TF32 off) on one full-width batch, same weights
    fp32 = Predictor(dataclasses.replace(cfg, use_amp=False), device="cuda")
    fp32.model.load_state_dict(fast.model.state_dict())
    arrays = [f.array for f in feed[:8]]
    head16 = fast.forward(fast.to_device(arrays))
    head32 = fp32.forward(fp32.to_device(arrays))
    bf16_rel = float((head16 - head32).abs().max() / head32.abs().max())
    del fp32, slow

    # throughput at batch 32 (PreparedImage feed: copy, forward, decode,
    # fetch, annotations) and the device split
    n_rounds = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        fast.predict_batch(feed)
    torch.cuda.synchronize()
    img_s = n_rounds * 32 / (time.perf_counter() - t0)
    batch = fast.to_device([f.array for f in feed])
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: fast.forward(batch), iters=10, warmup=2)
        head = fast.forward(batch)
        dec_b_ms = time_ms(lambda: fast.decode(head, fast_path=True), iters=10, warmup=2)
        dec_a_ms = time_ms(lambda: fast.decode(head, fast_path=False), iters=10, warmup=2)
    device_ms_per_img = measure_device_ms_per_img(fast, 32)
    objects = sum(len(a["objects"]) for a in anns_fast)

    emit({"phase": "serve", "card": card, "model": f"SDNet resnet34 fpn_depth="
          f"{cfg.fpn_depth} {cfg.width}x{cfg.height} {'bf16' if cfg.use_amp else 'fp32'}, "
          f"labels {list(cfg.labels)} / {list(cfg.parts)}, "
          f"{'weights ' + str(load_model) if load_model else 'seeded init'}",
          "setup_s": setup_s, "requests": len(bodies), "clients": 4,
          "http_batches": batches, "http_wall_s": http_s,
          "http_img_per_s": len(bodies) / http_s, "latency_ms": latency,
          "img_per_s_batch32": img_s, "device_ms_per_img_batch32": device_ms_per_img,
          "forward_ms_batch32": fwd_ms, "decode_kernel_b_ms_batch32": dec_b_ms,
          "decode_kernel_a_path_ms_batch32": dec_a_ms,
          "bf16_vs_fp32_max_rel": bf16_rel, "objects_in_batch32": objects,
          "launches": launches, "paths_identical": True})
    # bf16 keeps 8 bits of mantissa through 40 layers: 0.015 measured on
    # an NVIDIA H100 80GB HBM3 (700 W) with the seeded weights, 0.039 with
    # the earlier fan-out init; the bar is 0.08
    if bf16_rel > 0.08:
        raise AssertionError(f"bf16 head departs from fp32 by {bf16_rel:.3f} of scale")
    return launches


def phase_reference(card: str) -> None:
    """A small fp32 model on the card against the same model on the CPU."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.predictor import Predictor

    cfg = Config(width=128, height=128, fpn_depth=32, use_amp=False,
                 labels_path=ROOT / "labels.json").finalize()
    gpu, cpu = Predictor(cfg, device="cuda"), Predictor(cfg, device="cpu")
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (128, 128, 3), np.uint8) for _ in range(4)]
    with torch.inference_mode():
        head_gpu = gpu.forward(gpu.to_device(arrays)).cpu()
        head_cpu = cpu.forward(cpu.to_device(arrays))
        scale = float(head_cpu.abs().max())
        head_err = float((head_gpu - head_cpu).abs().max()) / scale
        dec_gpu = {k: v.cpu() for k, v in gpu.decode(head_cpu.cuda()).items()}
        dec_cpu = cpu.decode(head_cpu, fast_path=True)
    if head_err > 1e-4:
        raise AssertionError(f"card and CPU forwards differ by {head_err:.2e} of scale")
    for key in ("anchors", "parts"):
        torch.testing.assert_close(dec_gpu[key], dec_cpu[key], rtol=0, atol=1e-5)
    for key in ("part_parent", "part_valid"):
        if not torch.equal(dec_gpu[key], dec_cpu[key]):
            raise AssertionError(f"card and CPU decodes differ on {key}")
    emit({"phase": "reference", "card": card, "config": "128x128 fpn_depth=32 fp32 (TF32 off)",
          "head_max_rel_err": head_err, "decode": "card kernels == CPU plain versions"})


def phase_topk_variants(card: str) -> dict:
    """Kernel C's main path: the port's variant shootout at batch 128.
    Returns the launch counts of its run."""
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.tools import bench_topk_variants

    reset_launch_counts()
    result = bench_topk_variants.run()
    launches = launch_counts()
    if not launches["sigmoid_nms_topk_rowmax"]:
        raise AssertionError(f"the shootout did not launch kernel C: {launches}")
    emit({"phase": "topk_variants", "card": card, **result, "launches": launches})
    return launches


def _write_pngs(directory: Path, n: int, seed: int) -> None:
    """`n` lossless PNGs of mixed sizes (640x480, 800x600, 512x512,
    333x517): coarse noise upscaled, so the files are small and quick to
    write."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    sizes = [(640, 480), (800, 600), (512, 512), (333, 517)]
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(directory / f"img_{i:03d}.png")


def _sub_cell_offsets(model, cfg) -> None:
    """A trained head regresses offsets within a grid cell; a seeded one
    regresses several cells, which puts anchors near the border outside
    the image, where evaluate clips the ground truth to the image and
    the match radius (5 % of the image's short side) no longer reaches.
    Scale the seeded head's two offset rows down into a trained model's
    range."""
    import torch

    rows = slice(cfg.n_labels + cfg.n_parts, cfg.n_labels + cfg.n_parts + 2)
    with torch.no_grad():
        model.head.conv.weight[rows] *= 0.1
        model.head.conv.bias[rows] = 0.0


def _counts(evaluator) -> dict:
    """(tp, npos, ndet) of every label of every metric family."""
    families = ("anchor_eval", "part_eval", "csi_eval", "classification_eval")
    return {fam: {label: (e.tp, e.npos, e.ndet) for label, e in getattr(evaluator, fam).items()}
            for fam in families}


@contextlib.contextmanager
def _cwd(path: Path):
    old = Path.cwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def phase_evaluate_detect(card: str, load_model) -> dict:
    """The evaluate/detect main path at full width; returns the launch
    counts of its run."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.cli import detect, evaluate
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.weights import save_msgpack
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage

    n_images, batch, conf = 64, 32, 0.1
    sweep = (0.1, 0.3, 0.5)
    with tempfile.TemporaryDirectory(prefix="sdnet-smoke-") as tmp:
        tmp = Path(tmp)
        images = tmp / "images"
        images.mkdir()
        _write_pngs(images, n_images, seed=926354916)
        cfg = Config(labels_path=ROOT / "labels.json", pretrained_model=load_model).finalize()
        # the seeded model, written by the port as the JAX package's
        # save_params would, then loaded back by the CLIs
        warm = Predictor(cfg, device="cuda")
        if load_model is None:
            _sub_cell_offsets(warm.model, cfg)
        ckpt = save_msgpack(warm.model, tmp / "model_best_csi.msgpack")
        # cuDNN picks its algorithms per shape once a process: warm both
        # feeds at batch 32 so the timed runs below measure steady state
        feed = np.zeros((cfg.height, cfg.width, 3), np.uint8)
        warm.predict_batch([PreparedImage(feed, (cfg.width, cfg.height))] * batch)
        with torch.inference_mode():
            warm.model(torch.zeros((batch, 3, cfg.height, cfg.width), device=warm.device))
        torch.cuda.synchronize()
        del warm

        common = ["--labels", str(ROOT / "labels.json"), "--load_model", str(ckpt),
                  "--eval_batch_size", str(batch), "--num_workers", "4"]
        # --- the main path: counts set to 0 just before, read just after
        reset_launch_counts()
        with _cwd(tmp):
            t0 = time.perf_counter()
            out_dir = detect.main(["--valid_dir", str(images), "--conf_threshold", str(conf),
                                   *common])
            torch.cuda.synchronize()
            detect_s = time.perf_counter() - t0
        predictions = sorted((tmp / out_dir).glob("*.json"))
        t0 = time.perf_counter()
        swept = evaluate.main(["--valid_dir", str(tmp / out_dir), "--conf_sweep",
                               ",".join(map(str, sweep)), "--save_summary",
                               str(tmp / "sweep.json"), *common])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single_ev = evaluate.main(["--valid_dir", str(tmp / out_dir), "--conf_threshold",
                                   str(conf), "--save_summary", str(tmp / "one.json"), *common])
        torch.cuda.synchronize()
        evaluate_s = time.perf_counter() - t0
        launches = launch_counts()
        # --- end of the main path
        summaries = json.loads((tmp / "sweep.json").read_text())
        single = json.loads((tmp / "one.json").read_text())

    if len(predictions) != n_images:
        raise AssertionError(f"detect wrote {len(predictions)} predictions for {n_images} images")
    if not launches["sigmoid_nms"] or not launches["sigmoid_nms_topk"]:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    if set(summaries) != {f"{t:g}" for t in sweep}:
        raise AssertionError(f"--conf_sweep {sweep} gave summaries {sorted(summaries)}")
    first = summaries[f"{sweep[0]:g}"]
    if set(first) != set(single):
        raise AssertionError("the sweep's first summary has other keys than a single run")
    sweep_vs_single = max(abs(first[k] - single[k]) for k in single)
    ev = swept[sweep[0]]
    if _counts(ev) != _counts(single_ev[conf]):
        raise AssertionError("the sweep's first counters differ from a run without the sweep")
    objects = sum(e.npos for _, e in ev.anchor_eval.items())
    if objects < n_images:
        raise AssertionError(f"only {objects} ground-truth objects in {n_images} images")
    f1 = {label: e.f1_score for label, e in ev.anchor_eval.items() if e.npos or e.ndet}
    emit({"phase": "evaluate_detect", "card": card,
          "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height} "
                   f"{'bf16' if cfg.use_amp else 'fp32'}, "
                   f"{'weights ' + str(load_model) if load_model else 'seeded init'}",
          "images": n_images, "eval_batch_size": batch, "conf_threshold": conf,
          "conf_sweep": list(sweep), "gt_objects": objects,
          "anchor_f1_own_predictions": f1,
          "anchor_f1_by_threshold": {t: s["anchor/f1_total"] for t, s in summaries.items()},
          "sweep_first_vs_single_max_abs_diff": sweep_vs_single,
          "detect_img_per_s_batch32": n_images / detect_s,
          "evaluate_img_per_s_batch32": n_images / evaluate_s,
          "evaluate_sweep3_img_per_s_batch32": n_images / sweep_s,
          "timing": "host clock; detect includes PNG decode, resize, JSON and overlay "
                    "writes; evaluate includes loading and metric accumulation",
          "launches": launches})
    # detect normalizes on the card from uint8, evaluate on the host in
    # float32; under bf16 a near-tied 20th peak may swap
    low = {label: v for label, v in f1.items() if v < 0.99}
    if low or not f1:
        raise AssertionError(f"anchor F1 on the model's own predictions below 0.99: {f1}")
    if sweep_vs_single > 1e-6:
        raise AssertionError(
            f"the sweep's first summary departs from a single run by {sweep_vs_single}")
    return launches


def _train_batch(cfg, b: int, seed: int, normalized: bool):
    """A batch on the card with every keypoint slot filled: `max_objects`
    anchors and `max_parts` parts (two owned by each anchor), images
    uint8, or ImageNet-normalized float32 with `normalized`."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.ops.device_augment import normalize_images

    rng = np.random.default_rng(seed)
    # grid coordinates of input pixels clipped to [0, size - 1], as
    # `flatten_annotation` makes them
    top = np.array([cfg.width - 1, cfg.height - 1]) / cfg.down_ratio
    o, p = cfg.max_objects, cfg.max_parts
    anchors = rng.uniform(0, top, (b, o, 2)).astype(np.float32)
    owners = np.repeat(anchors, -(-p // o), axis=1)[:, :p]
    kp = {
        "anchors_xy": anchors,
        "anchor_cls": rng.integers(0, cfg.n_labels, (b, o)).astype(np.int32),
        "anchor_mask": np.ones((b, o), bool),
        "parts_xy": np.clip(owners + rng.normal(0, 3, owners.shape), 0, top).astype(np.float32),
        "part_kind": rng.integers(0, cfg.n_parts, (b, p)).astype(np.int32),
        "part_owner_xy": owners,
        "part_mask": np.ones((b, p), bool),
    }
    kp = {k: torch.from_numpy(v).cuda() for k, v in kp.items()}
    images = torch.from_numpy(rng.integers(0, 256, (b, cfg.height, cfg.width, 3), np.uint8))
    images = images.cuda()
    if normalized:
        images = normalize_images(images.float() / 255.0)
    return images, kp


def _time_train_steps(cfg, b: int, warmup: int = 5, iters: int = 20) -> dict:
    """ms a train step at batch `b` (device augmentation, uint8 feed),
    peak memory, the FLOPs of one step and their share of the dense bf16
    peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    state = create_train_state(cfg, init_model(cfg).cuda(), steps_per_epoch=1000)
    images, kp = _train_batch(cfg, b, seed=b, normalized=False)
    for _ in range(warmup):
        train_step(state, images, kp, cfg, augment=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        stats = train_step(state, images, kp, cfg, augment=True)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters
    loss = float(stats["total_loss"])
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as counter:
        train_step(state, images, kp, cfg, augment=True)
    flops = counter.get_total_flops()
    if not math.isfinite(loss):
        raise AssertionError(f"train step at batch {b}: loss {loss}")
    return {"batch": b, "ms_per_step": ms, "host_ms_per_step": host_ms,
            "img_per_s": b * 1e3 / ms, "max_memory_allocated_bytes": peak, "loss": loss,
            "flops_per_step": flops,
            "bf16_dense_peak_share": flops / (ms * 1e-3) / BF16_DENSE_OPS_PER_S,
            **_device_busy(lambda: train_step(state, images, kp, cfg, augment=True), ms)}


def _device_busy(step, ms_per_step: float, n: int = 3) -> dict:
    """A torch.profiler (CUPTI) trace of `n` steps: the card's busy ms a
    step (kernels, copies and sets; no annotation ranges), its idle share
    of the unprofiled step time `ms_per_step`, and the 5 kernels that take
    most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    busy = sum(by_name.values())
    if not busy:
        raise AssertionError("the profiler saw no device time in the train steps")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms_per_step": busy, "device_idle_share": 1.0 - busy / ms_per_step,
            "top_kernels_ms_per_step": [[name[:90], ms] for name, ms in top]}


def _write_annotated(directory: Path, n: int, seed: int) -> None:
    """`n` PNGs of mixed sizes with a JSON annotation beside each: 1-4
    plants (bean or maize), an "anchor" keypoint and 1-3 leaves each,
    drawn as discs on coarse noise."""
    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    sizes = [(640, 480), (512, 512), (800, 600), (333, 517)]
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        draw = ImageDraw.Draw(img)
        objects = []
        for _ in range(int(rng.integers(1, 5))):
            ax, ay = float(rng.uniform(20, w - 20)), float(rng.uniform(20, h - 20))
            draw.ellipse([ax - 9, ay - 9, ax + 9, ay + 9], fill=(200, 60, 60))
            parts = [{"kind": "anchor", "location": {"x": ax, "y": ay}, "score": None}]
            for _ in range(int(rng.integers(1, 4))):
                px = float(np.clip(ax + rng.normal(0, 25), 0, w - 1))
                py = float(np.clip(ay + rng.normal(0, 25), 0, h - 1))
                draw.ellipse([px - 5, py - 5, px + 5, py + 5], fill=(220, 220, 60))
                parts.append({"kind": "leaf", "location": {"x": px, "y": py}, "score": None})
            objects.append({"label": str(rng.choice(["bean", "maize"])), "box": None,
                            "parts": parts})
        img.save(directory / f"im_{i:03d}.png")
        (directory / f"im_{i:03d}.json").write_text(json.dumps(
            {"image_path": f"im_{i:03d}.png", "img_size": [w, h], "objects": objects}))


def _grad_gap(a, b) -> dict:
    """Relative L2 distance of two models' gradients: the worst tensor's
    and the whole's."""
    import torch

    names = [n for n, _ in a.named_parameters()]
    ga = {n: p.grad.detach().double().cpu() for n, p in a.named_parameters()}
    gb = {n: p.grad.detach().double().cpu() for n, p in b.named_parameters()}
    per = {n: float((ga[n] - gb[n]).norm() / gb[n].norm()) for n in names}
    whole = float(torch.cat([(ga[n] - gb[n]).flatten() for n in names]).norm()
                  / torch.cat([gb[n].flatten() for n in names]).norm())
    worst = max(per, key=per.get)
    return {"whole": whole, "worst_tensor": worst, "worst": per[worst],
            "head": per["head.conv.weight"]}


def phase_train(card: str) -> dict:
    """The training path at full width (resnet34, fpn_depth 128, 512x512,
    bf16, labels.json): the train step timed at batch 8 and 32, an
    overfit run, `cli.train` then `cli.evaluate` (kernel A in validation),
    and one fp32 step on the card against the CPU. Returns the launch
    counts of the `cli.train` run, the main path."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.cli import evaluate, train
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    t_phase = time.perf_counter()
    labels = ROOT / "labels.json"
    cfg = Config(labels_path=labels).finalize()
    if not (cfg.device_augment and cfg.uint8_feed and cfg.use_amp):
        raise AssertionError("the defaults must be device augment, uint8 feed, bf16")
    steps = [_time_train_steps(cfg, b) for b in (8, 32)]

    # overfit one fixed batch, augmentation off (the JAX package's own bar,
    # tests/test_train.py:85)
    state = create_train_state(cfg, init_model(cfg).cuda(), steps_per_epoch=1000)
    images, kp = _train_batch(cfg, 8, seed=3, normalized=True)
    curve = [float(train_step(state, images, kp, cfg)["total_loss"]) for _ in range(30)]
    del state
    if not curve[-1] < 0.7 * curve[0]:
        raise AssertionError(f"30 steps on one batch did not overfit: {curve}")

    with tempfile.TemporaryDirectory(prefix="sdnet-train-") as tmp:
        tmp = Path(tmp)
        _write_annotated(tmp / "train", 64, seed=1)
        _write_annotated(tmp / "valid", 16, seed=2)
        # --- the main path: counts set to 0 just before, read just after
        reset_launch_counts()
        with _cwd(tmp):
            t0 = time.perf_counter()
            trainer = train.main(["--train_dir", str(tmp / "train"), "--valid_dir",
                                  str(tmp / "valid"), "--labels", str(labels), "--epochs", "2",
                                  "--eval_batch_size", "16", "--num_workers", "4"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        launches = launch_counts()
        # --- end of the main path
        run = tmp / trainer.save_dir
        snapshots = sorted(p.name for p in run.glob("model_best_*.msgpack"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # its metric tables
            evaluators = evaluate.main([
                "--valid_dir", str(tmp / "valid"), "--labels", str(labels), "--load_model",
                str(run / "model_best_loss.msgpack"), "--eval_batch_size", "16",
                "--save_summary", str(tmp / "summary.json")])
        evaluate_s = time.perf_counter() - t0
        summary = json.loads((tmp / "summary.json").read_text())
        step_count, buckets = trainer.state.step, len(trainer.train_augmentation.bucket_sizes())
        del trainer
    if not launches["sigmoid_nms"]:
        raise AssertionError(f"validation did not launch kernel A: {launches}")
    if "model_best_loss.msgpack" not in snapshots or step_count != 2 * (64 // cfg.batch_size):
        raise AssertionError(f"cli.train: {step_count} steps, snapshots {snapshots}")
    if not all(np.isfinite(v) for v in summary.values()) or not evaluators:
        raise AssertionError(f"cli.evaluate on the trained checkpoint: {summary}")

    # one fp32 step of a small model on the card and on the CPU, same
    # weights and batch (TF32 off in the forward and the backward)
    small = Config(width=64, height=64, fpn_depth=32, use_amp=False,
                   labels_path=labels).finalize()
    models = {d: init_model(small).to(d) for d in ("cuda", "cpu")}
    images, kp = _train_batch(small, 8, seed=5, normalized=True)
    losses = {}
    for d, model in models.items():
        state = create_train_state(small, model, steps_per_epoch=1000)
        losses[d] = float(train_step(state, images.to(d), {k: v.to(d) for k, v in kp.items()},
                                     small)["total_loss"])
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    gap = _grad_gap(models["cuda"], models["cpu"])  # the step leaves its gradients in .grad
    emit({"phase": "train", "card": card,
          "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height} bf16, "
                   f"device augment (uint8 feed), max_objects {cfg.max_objects}, "
                   f"max_parts {cfg.max_parts}, every slot filled, seeded init",
          "steps": steps, "timing": "CUDA events over 20 steps after 5 warm-up steps; "
                                    "FLOPs from torch.utils.flop_counter on one step",
          "bf16_dense_peak_ops_per_s": BF16_DENSE_OPS_PER_S,
          "overfit_batch8_30_steps": curve,
          "cli_train": {"train_images": 64, "valid_images": 16, "epochs": 2,
                        "batch_size": cfg.batch_size, "eval_batch_size": 16,
                        "steps": step_count, "prewarmed_buckets": buckets,
                        "wall_s": train_s, "snapshots": snapshots},
          "cli_evaluate_wall_s": evaluate_s,
          "evaluate_summary": {k: summary[k] for k in ("anchor/f1_total", "kps/f1_total")},
          "card_vs_cpu_fp32": {"config": "64x64 fpn_depth=32 fp32 batch 8, TF32 off",
                               "loss": losses, "loss_rel_err": loss_rel,
                               "grad_rel_l2": gap},
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    if loss_rel > 1e-4:
        raise AssertionError(f"card and CPU train-step losses differ by {loss_rel:.2e}")
    # float32 gradients of this net depart from a float64 evaluation by up
    # to 0.64 % (relative L2) in a tensor on the CPU at this size
    # (tests/test_torch_port_train_step.py): the bars are 3 % a tensor,
    # 1 % for the whole gradient and 1e-3 for the head
    if gap["worst"] > 3e-2 or gap["whole"] > 1e-2 or gap["head"] > 1e-3:
        raise AssertionError(f"card and CPU gradients differ: {gap}")
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--load_model", type=Path, default=None,
                   help="a .pth or .msgpack to run instead of the seeded init")
    p.add_argument("--parent", type=Path, default=None,
                   help="another checkout (the parent commit): also time its kernels A, "
                        "B and C, through its public wrappers, against this one's, in turns")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "structuredetector_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from structuredetector_tpu_torch.tools.timing import card as query_card

    t_start = time.perf_counter()
    card = query_card()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    phase_build()
    kernels = phase_kernels(card)
    if args.parent is not None:
        phase_parent(card, args.parent.resolve())
    by_path = {"serve": phase_serve(card, args.load_model),
               "topk_variants": phase_topk_variants(card),
               "evaluate_detect": phase_evaluate_detect(card, args.load_model)}
    phase_reference(card)
    by_path["train"] = phase_train(card)

    sources = {
        "sigmoid_nms": ("structuredetector_tpu_torch/csrc/sigmoid_nms.cu",
                        "structuredetector_tpu/ops/pallas/nms.py:35"),
        "sigmoid_nms_topk": ("structuredetector_tpu_torch/csrc/sigmoid_nms_topk.cu",
                             "structuredetector_tpu/ops/pallas/topk.py:62"),
        "sigmoid_nms_topk_rowmax": ("structuredetector_tpu_torch/csrc/sigmoid_nms_topk_rowmax.cu",
                                    "structuredetector_tpu/ops/pallas/topk.py:116"),
    }
    extra = ("topk_partial_ms", "ms_by_k_64_planes", "ms_runs", "phases_ms",
             "copy_same_bytes_ms", "saturated_ms", "saturated_ms_runs", "saturated_bound_share",
             "us_per_round", "active_clusters")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(counts[name] for counts in by_path.values()),
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         **{k: v for k, v in kernels[name].items() if k not in extra}}
        for name, (src, replaces) in sources.items()
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
