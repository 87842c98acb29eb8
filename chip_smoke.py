#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`structuredetector_tpu_torch`).

    python3 chip_smoke.py [--load_model model.pth|model.msgpack] [--parent DIR]

Runs on one NVIDIA GPU from the root of a checkout and imports nothing
of JAX or of the JAX package. Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel from csrc/ (nvcc, sm_90a, one process
   per source, in parallel) and, beside them, the native I/O library
   from native/sdnet_io.cpp (g++), with its build seconds and route;
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
   timed card sampled beside the window; then the Swin core's kernel
   (csrc/swin_window_attention.cu) on the inputs of one seeded Swin-B
   SDNet forward at the swinv2b-infer-b32 cell's shapes (batch 32,
   512x512, bf16): its launches counted around that forward (24), each
   stage's even and odd block against the plain version in bf16 (the card
   test's bar, head by head) and float32 (1e-5), and the kernel, the
   plain version and the SDPA path it replaced timed per block, summed
   over the forward beside the bound of its bytes;
   with `--parent DIR` (a checkout of another commit), also that
   checkout's kernels A, B and C, called through its own public
   wrappers, against these, in turns (old, new, new, old), and its
   seeded full-width SDNet's forward (and one train-mode backward)
   bit for bit against this checkout's;
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
6b. native_io (main path of kernels A and B behind the native input
   tier, on evaluate_detect's checkpoint and 64 PNGs): the library must
   have built on this host (its route, "system" or "pillow", is
   reported); native exact decode against PIL at 512x512 on the PNGs
   and on them as JPEGs (byte-equal) and both decoders' img/s on one
   thread and on four; the train Loader's batches a second at batch 32,
   native against PIL, in turns; then, on the main path, `cli.evaluate`
   with its default and with `--no_native_io`, in turns (identical
   summaries, img/s of each), the default server against the PIL server
   (`native_decode: true` on /healthz, identical annotations for the 32
   PNG requests one at a time, client-side p50/p95 latency under 4
   clients, in turns) and `cli.train`'s wall time both ways, in turns.
   The native calls are counted, so the defaults must take the native
   path; kernels A and B must be launched; the host CPU's model and
   core count stand beside these host-clock numbers;
7. export (the deployment path, on evaluate_detect's checkpoint and
   PNGs): `cli.convert_export` writes a static batch-32 artifact and a
   `--uint8_input --dynamic_batch` one on the card; `ExportPredictor` on
   32 images gives `Predictor`'s annotations for each (heads within the
   bf16 bar); `cli.serve --artifact` in a process of its own answers
   concurrent PNG POSTs; `cli.evaluate_export` scores the 64 PNGs
   (anchor F1 at least 0.99 on the model's own predictions);
   ExportPredictor's img/s beside Predictor's at batch 32, in turns;
8. int8 (the JAX package's benchmark configuration: int8 convs, static
   scales calibrated on 16 images, prequantized weights): `_int_mm`'s
   rules on this card; the im2col product exact against the CPU on every
   int8 conv shape of the model and on maps of 16 rows or fewer; the int8
   forward at batch 32 and 128 beside bf16 (CUDA events, in turns), peak
   memory, predict_batch img/s; the int8 head's gap from bf16 (the JAX
   test's bar 0.25) and anchor-peak agreement; kernel B counted on the
   int8 Predictor path and kernel A on `cli.evaluate --int8`; a
   `convert_export --int8 --calibrate_dir` artifact through
   `evaluate_export`; a small fp32 int8 model on the card against the CPU;
9. reference: a small fp32 model on the card agrees with the same model
   on the CPU;
10. train (main path of kernel A): the train step at full width (bf16,
   device augmentation, uint8 feed, every keypoint slot filled) timed at
   batch 8 and 32 with CUDA events (ms, img/s, peak memory, finite loss,
   its FLOPs' share of the dense bf16 peak); 30 steps on one batch must
   cut the loss below 0.7 of the first; `cli.train` for 2 epochs on 64
   annotated PNGs (16 to validate, kernel A's counter must rise), then
   `cli.evaluate` on the `model_best_loss.msgpack` it wrote; one fp32
   step of a small model on the card against the CPU (loss within 1e-4
   relative, gradients within the bars stated there);
10b. data_parallel (main path of kernel A on every rank): two ranks
   share the card over gloo, launched with torchrun's environment, for 5
   fp32 steps at full width and global batch 32 (device augmentation,
   uint8 feed, half of rank 1's samples without a valid keypoint) against
   one process on the joined batch (loss trajectories, the first step's
   gradient and BN statistics, the parameters after step 5 within Adam's
   bound, both ranks identical, ms a step of the 2 ranks sharing the
   card); `torchrun --nproc_per_node 2 -m
   structuredetector_tpu_torch.cli.train --data_parallel 2` for 2 epochs
   on the train phase's 64 + 16 PNGs (rank 0 alone writes, kernel A
   launched on each rank, `cli.evaluate` on its checkpoint); a one-rank
   NCCL group's all_reduce, and the 2-rank step on NCCL where there are
   two cards;
10c. model_axis (the mesh's model axis; main path of kernel A on every
   rank and of kernel B on the row forward's gathered maps): ranks share
   the card over gloo at full width (resnet34, fpn_depth 128, 512x512,
   labels.json, seeded weights, fp32 with TF32 off): the 1 x 2
   tensor-parallel step (`--model_parallel 2`) for 3 steps at global
   batch 4 against one process (the first step's loss, gradient and BN
   statistics, the parameters within Adam's bound, each rank's elements
   against the rule of JAX's `param_shardings`, ms a step, peak memory a
   rank); `make_sharded_forward(spatial=True)` over 1 x 4 rows at batch 2
   against one forward (heads within 1e-4 of their scale, anchor F1 of
   the two decodes, kernel B on every rank's gathered maps); the 2 x 2
   spatial step's first step against the same one process and a float64
   step, then again with each `MA_FAULTS` fault planted in its backward,
   which the same gradient bar must refuse; `torchrun
   --nproc_per_node 2 -m structuredetector_tpu_torch.cli.train
   --model_parallel 2` for 2 epochs on the train phase's 64 + 16 PNGs
   (rank 0 alone writes, kernel A launched on each rank, `cli.evaluate`
   on its checkpoint in one process); (e) "tp_forward":
   `make_sharded_forward` on `create_mesh(1, 2)`, 2 ranks: a plain model
   at batch 1 and 2, a `shard_model` model through its plan at batch 2
   and with `spatial=True`, each rank's maps within 1e-5 of each map's
   scale of one process's forward, decoded through kernel B on each rank
   with anchor F1 1.0 against one process's, ms of each (median of 5);
10d. library: `import structuredetector_tpu_torch` in a fresh process
   loads no JAX, no `torch.utils.cpp_extension` and no `parallel/`;
   every top-level name resolves; `structuredetector_tpu_torch.Predictor`
   at full width (seeded weights, bf16) predicts a batch of 32 through
   kernel B; the seeded full-width model written with
   `save_reference_pth` loads strictly into a fresh SDNet
   (`load_weights`) whose eval forward on the card is bit-identical;
   every `structuredetector_tpu_torch.tools` module imports in a fresh
   process without JAX, the JAX package or the repo-root `tools/`;
10e. accuracy (main path of kernel A in validation, the gate's
   checkpoint arm, oracle arm D and the conf sweep, and of kernel B in
   the served load test): `tools.accuracy_run` at a reduced depth (320
   train / 16 valid rendered images, the first one's SHA-256 printed;
   `cli.train` under `tools.supervise` with the flagship recipe for 60
   epochs at a constant learning rate (`--lr_step 1`); the gate's four
   arms on `model_best_csi.msgpack`, printed as its table; oracle arm D;
   a 5 s load test at max_batch 32; the conf sweep), its train and serve
   subprocesses counting their own launches (`--counts_out`); the
   checkpoint row's anchor F1 must be at least 0.5 and the float
   artifact's kps F1 within 0.01 of it;
11. variants (main path of kernels A and B for the model variants): at
   full width (512x512, fpn_depth 128, bf16, labels.json, seeded
   weights) resnet18, resnet50, resnet34 with `--s2d_stem` and with
   `--head_conv 64`, each: the batch-32 forward (CUDA events) and its
   peak memory, `predict_batch` img/s (kernel B's counter must rise),
   the Decoder path (kernel A) identical to the serving decode, a
   batch-32 train step (ms, peak memory, finite loss, FLOPs' share of
   the bf16 peak, idle share), a small fp32 model on the card against
   the CPU; then resnet50 through `cli.train --pretrained` (a
   torchvision-layout resnet50 written from a seeded model into a
   temporary TORCH_HOME; kernel A in validation) and `cli.evaluate
   --backbone resnet50` on its checkpoint (without the flag it must
   raise); a 7x7 checkpoint in an s2d model (heads within the bf16 bar,
   fp32 detections equal); resnet50 int8 with static scales (every int8
   conv shape exact against the CPU, the forward beside bf16 in turns);
   a `convert_export --head_conv 64` artifact whose `ExportPredictor`
   annotations equal `Predictor`'s;
12. benchmark: `cli.benchmark --json` in a process of its own for
   resnet34 bf16, resnet50 bf16 and resnet34 `--int8_static`, each
   printed; kernel A counted by the process itself, and `forward_fps`
   within 10 % of the batch-32 forward the serve, variants and int8
   phases timed in this run.

Each main path is driven with the launch counts set to 0 just before it
and read just after; the `kernels` line gives each kernel's launches by
path (`launches_by_path`, native_io included, the kernels phase's Swin
forward as `swin_forward`). Then the `{"kernels": [...]}` line, the nvidia-smi
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
def phase_build() -> dict:
    """Compiles the kernels (nvcc, one process a source) and, beside them,
    the native I/O library (g++). Returns the library's build: its seconds
    or the compiler's error."""
    from structuredetector_tpu_torch.data import native
    from structuredetector_tpu_torch.ops.kernels import _build

    library: dict = {}

    def build_native():
        try:
            library["seconds"] = native.build()
            library["route"], library["library"] = native.route(), native.library_path().name
        except RuntimeError as e:
            library["error"] = str(e)

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    seconds = _build.build()
    native_thread.join()
    report = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
              for name, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "ptxas": report, "native_io": library})
    return library


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


def _swin_kernel_tests():
    """The Swin core's card test module: its bf16 bar
    (`assert_within_bf16_rounding`) and `sdpa_core`, the core as the port
    ran it before the kernel (the library yardstick)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_port_swin_kernel

    return test_torch_port_swin_kernel


def swin_window_attention_entry() -> tuple:
    """The Swin core's kernel on the inputs of one seeded Swin-B SDNet
    forward at the swinv2b-infer-b32 cell's shapes (batch 32, 512x512,
    bf16 autocast): the launch counts reset just before that forward and
    read just after it (24, one a block), then for the first block of each
    stage, even and odd, the kernel against `window_attention_reference`
    in bf16 (the card test's bar, head by head) and in float32 (within
    1e-5 of the largest output, TF32 off), bit for bit between two
    launches, and the device ms of the kernel in bf16 and float32, of the
    plain version and of the SDPA path it replaced. The forward's totals
    weigh each block's ms by its count; the bound is the bytes of that
    run's inputs (qkv, the biases, the logit scales) and output at
    HBM_BYTES_PER_S. Returns the kernel's entry and the forward's launch
    counts."""
    import torch

    from structuredetector_tpu_torch.models import swin
    from structuredetector_tpu_torch.models.network import SDNet
    from structuredetector_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
        window_attention,
        window_attention_reference,
    )

    tests = _swin_kernel_tests()
    torch.manual_seed(20261018)
    model = SDNet(2, 1, 128, dtype=torch.bfloat16, backbone="swin_v2_b").cuda().eval()
    x = torch.randn(32, 3, 512, 512, device="cuda")
    calls = []

    def recorded(qkv, *rest):
        calls.append((qkv, *rest))
        return window_attention(qkv, *rest)

    with torch.no_grad(), _patched(swin, "window_attention", recorded):
        model(x, raw_output=True)  # warm: builds the kernel
        calls.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        model(x, raw_output=True)
        torch.cuda.synchronize()
        counts = launch_counts()
    del model
    if counts["swin_window_attention"] != 24 or len(calls) != 24:
        raise AssertionError(f"a Swin-B forward launched {counts['swin_window_attention']} "
                             f"window-attention kernels over {len(calls)} blocks, not 24")

    def key(call):
        return f"stage{1 + {128: 0, 64: 1, 32: 2, 16: 3}[call[0].shape[1]]}." + (
            "odd" if call[4] else "even")

    def n_bytes(call):
        qkv = call[0]
        return (qkv.numel() * 4 // 3 * qkv.element_size()
                + sum(t.numel() * t.element_size() for t in call[1:4]))

    blocks = {}
    plain_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    clocks = {}
    try:
        with torch.no_grad(), sampled_clocks(clocks):
            for call in calls:
                if key(call) in blocks:
                    continue
                qkv, bias, pos, scale, odd = call
                if qkv.dtype != torch.bfloat16:
                    raise AssertionError(f"autocast gave the core {qkv.dtype} qkv, not bf16")
                truth = window_attention_reference(qkv.float(), bias, pos.float(), scale, odd)
                plain = window_attention_reference(qkv, bias, pos, scale, odd)
                got, again = window_attention(*call), window_attention(*call)
                tests.assert_within_bf16_rounding(got, plain, truth)
                f32 = (qkv.float(), bias.float(), pos.float(), scale.float(), odd)
                got32, again32 = window_attention(*f32), window_attention(*f32)
                gap32 = tests.gap(got32, window_attention_reference(*f32))
                if gap32 > 1e-5:
                    raise AssertionError(f"{key(call)}: float32 gap {gap32} > 1e-5")
                if not (torch.equal(got, again) and torch.equal(got32, again32)):
                    raise AssertionError(f"{key(call)}: two launches differ")
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    library_ms = time_ms(lambda: tests.sdpa_core(*call), iters=10, warmup=2)
                blocks[key(call)] = {
                    "ms": time_ms(lambda: window_attention(*call), iters=50),
                    "float32_ms": time_ms(lambda: window_attention(*f32), iters=20),
                    "plain_ms": time_ms(lambda: window_attention_reference(*call), iters=10,
                                        warmup=2),
                    "library_ms": library_ms,
                    "bytes": n_bytes(call),
                    "bf16_gap": tests.gap(got, truth), "plain_bf16_gap": tests.gap(plain, truth),
                    "float32_gap": gap32}
                del truth, plain, got, again, f32, got32, again32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = plain_tf32
    for b in blocks.values():
        b["bound_ms"], _ = bound_ms(b["bytes"], 0)
        b["bound_share"] = b["bound_ms"] / b["ms"]
    per_block = [blocks[key(call)] for call in calls]
    total = {name: sum(b[name] for b in per_block) for name in ("ms", "plain_ms", "library_ms")}
    bound = bound_ms(sum(n_bytes(call) for call in calls), 0)[0]
    entry = {**total, "bf16_gap_max": max(b["bf16_gap"] for b in blocks.values()),
             "float32_gap_max": max(b["float32_gap"] for b in blocks.values()),
             "bound_ms": bound, "bound_by": "bytes",
             "bound_share": bound / total["ms"],
             "timed_work": "one Swin-B SDNet forward's 24 cores at batch 32, 512x512, bf16: "
                           "each block's ms (mean of 50, warm L2; plain and library of 10) "
                           "weighed by its count; library: the SDPA path of "
                           "tests/test_torch_port_swin_kernel.py::sdpa_core under autocast",
             "blocks": blocks, "block_counts": {k: sum(key(c) == k for c in calls)
                                               for k in blocks},
             "clocks": clocks}
    return entry, counts


def phase_kernels(card: str) -> tuple:
    """Bit-exactness and timings; returns the per-kernel measurements and
    the Swin forward's launch counts."""
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
    # the Swin core's kernel: not bit-exact (float arithmetic in another
    # order), held to the card test's bars on one forward's inputs
    result["swin_window_attention"], swin_counts = swin_window_attention_entry()
    emit({"phase": "kernels", "card": card, "bit_exact": True, "cases": list(cases),
          "timed_work": "one served batch of 32 at 512x512: anchors (32,2,128,128) + "
                        "parts (32,1,128,128), N(0, 3) logits; saturated_*: the same "
                        "shapes at -20 with 4 peaks a plane; warm L2, CUDA events, "
                        "mean of 50",
          "topk_partial_ms_is": "torch.topk over the suppressed planes only (partial)",
          "empty_kernel_ms": empty_ms, "clocks": clocks, **result})
    return result, swin_counts


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
          "forward_bit_equal": _forward_against_parent(),
          "clocks": clocks, **result})
    return result


def _forward_against_parent() -> dict:
    """The parent checkout's seeded full-width SDNet (512x512, fpn_depth
    128, labels.json) against this one's on one batch of 2, cuDNN
    deterministic: each variant's eval-mode head output, and resnet34
    bf16's train-mode head output and parameter gradients, bit for bit.
    Raises where they differ."""
    import importlib

    import torch

    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models import network as new

    old = importlib.import_module("sdnet_parent.models.network")
    x = torch.randn(2, 3, 512, 512, generator=torch.Generator().manual_seed(5)).cuda()
    variants = {"resnet34 bf16": {}, "resnet34 fp32": dict(use_amp=False),
                "resnet50 bf16": dict(backbone="resnet50"),
                "resnet34 s2d bf16": dict(s2d_stem=True),
                "resnet34 head_conv64 bf16": dict(head_conv=64)}
    equal = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        for name, overrides in variants.items():
            cfg = Config(labels_path=ROOT / "labels.json", **overrides).finalize()
            outs = []
            for mod in (old, new):
                with torch.no_grad():
                    outs.append(mod.init_model(cfg).cuda()(x, raw_output=True))
            equal[name] = torch.equal(*outs)
        cfg = Config(labels_path=ROOT / "labels.json").finalize()
        runs = []
        for mod in (old, new):
            model = mod.init_model(cfg).cuda().train()
            y = model(x, raw_output=True)
            y.square().mean().backward()
            runs.append([y.detach(), *(p.grad for p in model.parameters())])
        equal["resnet34 bf16 train: head and gradients"] = all(
            torch.equal(a, b) for a, b in zip(*runs))
    if not all(equal.values()):
        raise AssertionError(f"this checkout's forward departs from the parent's: {equal}")
    return equal


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


def phase_serve(card: str, load_model):
    """The main path; returns the launch counts of its run and the batch-32
    forward's ms."""
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
    return launches, fwd_ms


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


def phase_evaluate_detect(card: str, load_model, tmp: Path):
    """The evaluate/detect main path at full width, in the working
    directory `tmp`, where it leaves its PNGs (`images/`), the checkpoint
    and detect's predictions for the export and int8 phases. Returns the
    launch counts of its run, the checkpoint and the predictions' directory."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.cli import detect, evaluate
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.weights import save_msgpack
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage

    n_images, batch, conf = 64, 32, 0.1
    sweep = (0.1, 0.3, 0.5)
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
    return launches, ckpt, tmp / out_dir


def _host_cpu() -> dict:
    """The host CPU beside host-clock numbers: what /proc/cpuinfo says of
    its model, and its core counts."""
    first = Path("/proc/cpuinfo").read_text().split("\n\n", 1)[0]
    info = dict(line.split(":", 1) for line in first.splitlines() if ":" in line)
    info = {k.strip(): v.strip() for k, v in info.items()}
    return {**{k: info.get(k) for k in ("model name", "vendor_id", "cpu family", "model")},
            "logical_cpus": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0))}


@contextlib.contextmanager
def _calls_counted(module, names, counts: dict):
    """Count the calls of `module.<name>` for each name, for the block."""
    lock = threading.Lock()
    real = {name: getattr(module, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            with lock:
                counts[name] = counts.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def _jpeg_set(gt_dir: Path, out: Path) -> None:
    """`gt_dir`'s annotated images as JPEGs (quality 90) under `out`, the
    annotations pointing at them."""
    from PIL import Image

    out.mkdir()
    for js in sorted(gt_dir.glob("*.json")):
        data = json.loads(js.read_text())
        jpg = out / (Path(data["image_path"]).stem + ".jpg")
        with Image.open(data["image_path"]) as im:
            im.convert("RGB").save(jpg, quality=90)
        data["image_path"] = str(jpg)
        (out / js.name).write_text(json.dumps(data))


def _decode_compared(paths, w: int, h: int) -> dict:
    """Native exact decode against PIL at the network size, uint8 feed:
    the largest pixel difference, and img/s on one thread (one image at a
    time) and on four (native `load_batch` against PIL on a pool of four,
    as the Loader runs it), in turns."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from structuredetector_tpu_torch.data import native

    def pil(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR))

    def nat(path):
        return native.load_image(path, w, h, normalize=False, dtype=np.uint8)[0]

    def one_thread(fn):
        return lambda: [fn(p) for p in paths]

    def four_pil():
        with ThreadPoolExecutor(4) as pool:
            return list(pool.map(pil, paths))

    def four_native():
        return native.load_batch(paths, w, h, n_threads=4, normalize=False, dtype=np.uint8)

    max_diff = max(int(np.abs(nat(p).astype(np.int16) - pil(p)).max()) for p in paths)
    rates = {}
    for name, fn in (("native_1_thread", one_thread(nat)), ("pil_1_thread", one_thread(pil)),
                     ("pil_1_thread", one_thread(pil)), ("native_1_thread", one_thread(nat)),
                     ("native_4_threads", four_native), ("pil_4_threads", four_pil),
                     ("pil_4_threads", four_pil), ("native_4_threads", four_native)):
        t0 = time.perf_counter()
        fn()
        rates.setdefault(name, []).append(len(paths) / (time.perf_counter() - t0))
    return {"max_abs_pixel_diff": max_diff, "img_per_s": rates}


def _serve_once(predictor, bodies, clients: int) -> dict:
    """`make_server` on the predictor answers `bodies` from `clients`
    threads; the answers, the client-side latency of each request (decode
    included) and the batcher's counters."""
    import statistics

    from structuredetector_tpu_torch.serve import make_server

    server, batcher = make_server(predictor, "127.0.0.1", 0, max_batch=32, window_ms=20.0,
                                  submit_timeout_s=120.0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers, latency = [None] * len(bodies), [0.0] * len(bodies)

    def client(c: int):
        for i in range(c, len(bodies), clients):
            t0 = time.perf_counter()
            answers[i] = _post(url + "/detect", bodies[i])
            latency[i] = (time.perf_counter() - t0) * 1e3

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            native_decode = json.loads(resp.read())["model"]["native_decode"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or None in answers:
            raise AssertionError("a client did not finish")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    cuts = statistics.quantiles(latency, n=20, method="inclusive")
    return {"answers": answers, "native_decode": native_decode,
            "client_p50_ms": statistics.median(latency), "client_p95_ms": cuts[18],
            "img_per_s": len(bodies) / wall, "batches": batcher.batches_run,
            "batcher_latency_ms": batcher.latency_stats()}


def phase_native_io(card: str, library: dict, tmp: Path, ckpt: Path, gt_dir: Path) -> dict:
    """The native input tier at full width on evaluate_detect's checkpoint
    and 64 PNGs. The library must have built on this host (else this
    raises with the compilers' messages). Decode against PIL on the PNGs
    and on them as JPEGs (byte-equal) and both decoders' img/s; the train
    Loader's batches at 32 and `cli.train`, native against PIL, in
    turns; then, on the main path, `cli.evaluate` with its default and
    with `--no_native_io`, in turns (identical summaries, img/s of each),
    and the default server against the PIL server (`native_decode: true`
    on /healthz, identical annotations one request at a time, client
    latency under 4 clients in turns). The native calls are counted, so
    the defaults are shown to take the native path. Returns the launch
    counts of its main path."""
    import numpy as np
    import torch

    from structuredetector_tpu_torch.cli import evaluate, train
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.data import native
    from structuredetector_tpu_torch.data.augment import TrainAugmentation
    from structuredetector_tpu_torch.data.dataset import CropDataset
    from structuredetector_tpu_torch.data.pipeline import Loader, choose_batch_fetch
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage
    from structuredetector_tpu_torch.serve import decode_request, make_request_decoder

    t_phase = time.perf_counter()
    if "error" in library or not native.available():
        raise AssertionError(f"the native I/O library did not build on this host: "
                             f"{library.get('error') or native.build_error()}")
    labels = ROOT / "labels.json"
    cfg = Config(labels_path=labels, pretrained_model=ckpt).finalize()
    w, h = cfg.width, cfg.height
    pngs = sorted((tmp / "images").glob("*.png"))
    _jpeg_set(gt_dir, tmp / "jpeg")
    jpegs = sorted((tmp / "jpeg").glob("*.jpg"))
    decode = {"png": _decode_compared(pngs, w, h), "jpeg": _decode_compared(jpegs, w, h)}
    if any(d["max_abs_pixel_diff"] for d in decode.values()):
        raise AssertionError(f"native exact decode departs from PIL: {decode}")

    pred = Predictor(cfg, device="cuda")
    bodies = [p.read_bytes() for p in pngs[:32]]
    decode_native = make_request_decoder(pred, use_native=True)
    for body in bodies:
        if not np.array_equal(decode_native(body).array, pred.transform(decode_request(body))):
            raise AssertionError("the native request decode departs from the PIL transform")
    warm = [PreparedImage(np.zeros((h, w, 3), np.uint8), (w, h))] * 32
    for b in (1, 2, 4, 8, 16, 32):  # the shapes the batcher pads to
        pred.predict_batch(warm[:b])

    train_dir, valid_dir = tmp / "native_train", tmp / "native_valid"
    _write_annotated(train_dir, 64, seed=1)
    _write_annotated(valid_dir, 16, seed=2)
    aug = TrainAugmentation(cfg)
    ds = CropDataset(cfg, train_dir, aug)
    ds.localize_image_names()
    loaders = {"native": Loader(ds, 32, shuffle=True, drop_last=True, num_workers=4,
                                batch_fetch=choose_batch_fetch(cfg, ds, aug)),
               "pil": Loader(CropDataset(dataclasses.replace(cfg, native_io=False),
                                         train_dir, aug),
                             32, shuffle=True, drop_last=True, num_workers=4)}
    if loaders["native"].batch_fetch is None:
        raise AssertionError("the train Loader did not take the native path")
    first = {k: next(iter(loader))["image"] for k, loader in loaders.items()}
    if first["native"].dtype != np.uint8 or not np.array_equal(first["native"], first["pil"]):
        raise AssertionError("native and PIL train batches differ")
    loader_rate: dict = {}
    for which in ("native", "pil", "pil", "native"):
        t0, n = time.perf_counter(), 0
        for epoch in range(3):
            loaders[which].set_epoch(epoch)
            n += sum(1 for _ in loaders[which])
        loader_rate.setdefault(which, []).append(n / (time.perf_counter() - t0))

    common = ["--valid_dir", str(gt_dir), "--labels", str(labels), "--load_model", str(ckpt),
              "--eval_batch_size", "32", "--num_workers", "4", "--conf_threshold", "0.1"]
    flags = {"default": [], "pil": ["--no_native_io"]}
    calls: dict = {}
    # --- the main path: counts set to 0 just before, read just after
    reset_launch_counts()
    with _calls_counted(native, ("load_batch", "decode_bytes"), calls):
        evaluate_rate, summaries = {}, {}
        for which in ("default", "pil", "pil", "default"):
            out = tmp / f"native_io_{which}.json"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # its metric tables
                evaluate.main([*common, *flags[which], "--save_summary", str(out)])
            torch.cuda.synchronize()
            evaluate_rate.setdefault(which, []).append(len(pngs) / (time.perf_counter() - t0))
            summaries.setdefault(which, []).append(json.loads(out.read_text()))
        evaluate_calls = calls.get("load_batch", 0)

        def server(which):
            if which == "default":
                return contextlib.nullcontext()
            return _patched(native, "supports_decode_bytes", lambda: False)

        served = {}
        for which in ("default", "pil"):  # one request at a time: batch 1 each
            with server(which):
                served[which] = _serve_once(pred, bodies, clients=1)
        latency: dict = {}
        for which in ("default", "pil", "pil", "default"):
            with server(which):
                run = _serve_once(pred, bodies, clients=4)
            run.pop("answers")
            latency.setdefault(which, []).append(run)
        decode_calls = calls.get("decode_bytes", 0)

        train_s: dict = {}
        for which in ("default", "pil", "pil", "default"):
            with _cwd(tmp), contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                train.main(["--train_dir", str(train_dir), "--valid_dir", str(valid_dir),
                            "--labels", str(labels), "--epochs", "2", "--eval_batch_size",
                            "16", "--num_workers", "4", *flags[which]])
                torch.cuda.synchronize()
                train_s.setdefault(which, []).append(time.perf_counter() - t0)
        train_calls = calls.get("load_batch", 0) - evaluate_calls
    launches = launch_counts()
    # --- end of the main path

    if any(s != summaries["pil"][0] for runs in summaries.values() for s in runs):
        raise AssertionError(f"cli.evaluate summaries differ default/--no_native_io: "
                             f"{summaries}")
    if served["default"]["answers"] != served["pil"]["answers"]:
        raise AssertionError("the default server's annotations differ from the PIL server's")
    reported = [r["native_decode"] for r in [served["default"], *latency["default"]]]
    if reported != [True] * 3 or any(r["native_decode"] for r in latency["pil"]):
        raise AssertionError(f"/healthz native_decode {reported} on the default server")
    if not (evaluate_calls and train_calls and decode_calls == 3 * len(bodies)):
        raise AssertionError(f"native calls: evaluate {evaluate_calls} load_batch, train "
                             f"{train_calls}, serve {decode_calls} decode_bytes")
    if not launches["sigmoid_nms"] or not launches["sigmoid_nms_topk"]:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")

    def mean(xs):
        return sum(xs) / len(xs)

    emit({"phase": "native_io", "card": card, "host_cpu": _host_cpu(),
          "library": library, "net_size": [w, h], "images": len(pngs),
          "decode_vs_pil": decode,
          "evaluate_img_per_s_batch32": {k: mean(v) for k, v in evaluate_rate.items()},
          "evaluate_img_per_s_runs": evaluate_rate, "evaluate_summaries_identical": True,
          "serve_annotations_identical": True,
          "serve_client_latency_ms": {k: {"p50": mean([r["client_p50_ms"] for r in v]),
                                          "p95": mean([r["client_p95_ms"] for r in v])}
                                      for k, v in latency.items()},
          "serve_runs": latency,
          "train_loader_batches_per_s_batch32": loader_rate, "cli_train_wall_s": train_s,
          "native_calls": {"evaluate_load_batch": evaluate_calls,
                           "train_load_batch": train_calls, "serve_decode_bytes": decode_calls},
          "timing": "host clock; 'default' is the entry point as a user runs it, 'pil' with "
                    "--no_native_io (the PIL server), in turns; serve latency at the client "
                    "(decode included), 32 PNG requests, 4 clients, window 20 ms, max batch 32",
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


@contextlib.contextmanager
def _patched(module, name: str, value):
    """`module.<name>` set to `value` for the block, then restored."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_artifact(artifact: Path, bodies, cwd: Path) -> dict:
    """`python -m structuredetector_tpu_torch.cli.serve --artifact` in a
    process of its own, with `--pipeline` (it measures the card through
    the artifact to decide on the depth-2 pipeline, then warms every batch
    shape up to 32 through it); 4 clients POST `bodies`; the process is
    stopped after. Returns the answers, the server's /healthz and the
    seconds to ready."""
    import signal
    import subprocess

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    log = open(cwd / "serve_artifact.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "structuredetector_tpu_torch.cli.serve", "--artifact",
         str(artifact), "--port", str(port), "--batch_window_ms", "20", "--max_batch", "32",
         "--pipeline"],
        cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"serve --artifact exited with {proc.returncode}: "
                                     + (cwd / "serve_artifact.log").read_text()[-2000:])
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5):
                    break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("serve --artifact did not come up in 300 s")
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        answers = [None] * len(bodies)

        def client(c: int):
            for i in range(c, len(bodies), 4):
                answers[i] = _post(url + "/detect", bodies[i])

        clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    if None in answers:
        raise AssertionError("serve --artifact left a request unanswered")
    said = [ln for ln in (cwd / "serve_artifact.log").read_text().splitlines()
            if ln.startswith(("measured", "pipeline", "serving"))]
    return {"answers": answers, "health": health, "ready_s": ready_s, "log": said}


def _img_per_s(predict, feed, rounds: int = 10) -> float:
    """Host-clock images a second of `predict(feed)`, warm."""
    import torch

    predict(feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        predict(feed)
    torch.cuda.synchronize()
    return rounds * len(feed) / (time.perf_counter() - t0)


def _in_turns(fns: dict, measure) -> dict:
    """`measure(fn)` of two functions in turns a, b, b, a: their means and
    runs."""
    (a, fa), (b, fb) = fns.items()
    runs = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        runs[name].append(measure(fn))
    return {name: {"mean": sum(v) / 2, "runs": v} for name, v in runs.items()}


def phase_export(card: str, tmp: Path, ckpt: Path, gt_dir: Path) -> dict:
    """The deployment path at full width (resnet34, fpn_depth 128, 512x512,
    bf16, labels.json), on the checkpoint and predictions that
    evaluate_detect left in `tmp`: `cli.convert_export` writes a static
    batch-32 artifact and a `--uint8_input --dynamic_batch` one on the card;
    `ExportPredictor.predict_batch` on 32 images gives `Predictor`'s
    annotations for each (its heads within the bf16 bar of the serve
    phase); `cli.serve --artifact` answers concurrent PNG POSTs;
    `cli.evaluate_export` scores the 64 PNGs against detect's predictions;
    ExportPredictor's img/s beside Predictor's at batch 32 (host clock,
    in turns). Returns the launch counts of the run: none, since the
    program holds no kernel and its decode is the plain top-k."""
    import numpy as np
    import torch
    from PIL import Image

    from structuredetector_tpu_torch.cli import convert_export, evaluate_export
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.ops.tensor import clamped_sigmoid, plateau_nms
    from structuredetector_tpu_torch.predictor import ExportPredictor, Predictor, PreparedImage

    labels = ROOT / "labels.json"
    cfg = Config(labels_path=labels, pretrained_model=ckpt).finalize()
    nb = cfg.n_labels + cfg.n_parts
    images = [Image.open(p).convert("RGB") for p in sorted((tmp / "images").glob("*.png"))[:32]]
    rng = np.random.default_rng(926354916)
    bodies = [_png(rng, *im.size) for im in images[:16]]

    # the live model's annotations and suppressed heads on the two feeds
    # the artifacts take: host-normalized float32 and uint8
    live = {"static32": Predictor(cfg, device="cuda", device_normalize=False),
            "uint8_dynamic": Predictor(cfg, device="cuda", device_normalize=True)}
    arrays, want, ref = {}, {}, {}
    for name, pred in live.items():
        want[name] = [a.json_repr() for a in pred.predict_batch(images)]
        arrays[name] = [pred.transform(im) for im in images]
        with torch.inference_mode():
            head = pred.forward(pred.to_device(arrays[name]))
            ref[name] = torch.cat((plateau_nms(clamped_sigmoid(head[:, :nb])), head[:, nb:]), 1)
    torch.cuda.synchronize()

    # --- the main path: counts set to 0 just before, read just after
    reset_launch_counts()
    artifacts, convert_s = {}, {}
    for name, flags in (("static32", ["--batch_size", "32"]),
                        ("uint8_dynamic", ["--uint8_input", "--dynamic_batch"])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            artifacts[name] = convert_export.main([str(ckpt), "-o", str(tmp / f"{name}.sdz"),
                                                   "--params", str(labels), *flags])
        convert_s[name] = time.perf_counter() - t0
    exported = {name: ExportPredictor(path) for name, path in artifacts.items()}
    agreement = {}
    for name, ep in exported.items():
        got = [a.json_repr() for a in ep.predict_batch(images)]
        head = ep.forward(ep.to_device(arrays[name]))
        agreement[name] = {
            "annotations_equal": got == want[name],
            "objects": sum(len(a["objects"]) for a in want[name]),
            "head_bit_identical": bool(torch.equal(head, ref[name])),
            "head_max_rel": float((head - ref[name]).abs().max() / ref[name].abs().max()),
        }
        if not agreement[name]["annotations_equal"]:
            raise AssertionError(f"ExportPredictor ({name}) and Predictor disagree: "
                                 f"{agreement[name]}")
        # the bf16 bar of the serve phase
        if agreement[name]["head_max_rel"] > 0.08:
            raise AssertionError(f"the {name} artifact's head departs from the live "
                                 f"model's: {agreement[name]}")
    served = _serve_artifact(artifacts["uint8_dynamic"], bodies, tmp)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its metric tables
        evaluator = evaluate_export.main([str(artifacts["static32"]), "--valid_dir", str(gt_dir),
                                          "--conf_threshold", "0.1", "--num_workers", "4",
                                          "--save_summary", str(tmp / "export.json")])
    torch.cuda.synchronize()
    evaluate_export_s = time.perf_counter() - t0
    launches = launch_counts()
    # --- end of the main path
    if any(launches.values()):
        raise AssertionError(f"the export path holds no kernel, yet launched {launches}")

    for body, ans in zip(bodies, served["answers"]):
        with Image.open(io.BytesIO(body)) as im:
            if ans["img_size"] != list(im.size):
                raise AssertionError(f"serve --artifact answered {ans['img_size']} for {im.size}")
        for obj in ans["objects"]:
            if obj["label"] not in cfg.labels:
                raise AssertionError(f"malformed object in an answer: {obj}")
    if served["health"]["images_run"] != len(bodies):
        raise AssertionError(f"serve --artifact: {served['health']}")
    f1 = {label: e.f1_score for label, e in evaluator.anchor_eval.items() if e.npos or e.ndet}
    low = {label: v for label, v in f1.items() if v < 0.99}
    if low or not f1:
        raise AssertionError(f"evaluate_export: anchor F1 on the model's own predictions "
                             f"below 0.99: {f1}")

    # throughput at batch 32 in turns, each pair on one feed: the live
    # predictor against the artifact that takes the same feed
    rates = {}
    for name, ep in exported.items():
        pred = live[name]
        feed = [PreparedImage(a, im.size) for a, im in zip(arrays[name], images)]
        rates[name] = _in_turns({"Predictor": pred.predict_batch,
                                 "ExportPredictor": ep.predict_batch},
                                lambda fn, feed=feed: _img_per_s(fn, feed))
    emit({"phase": "export", "card": card,
          "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height} bf16, "
                   "the evaluate_detect checkpoint",
          "convert_export_s": convert_s,
          "artifact_bytes": {k: v.stat().st_size for k, v in artifacts.items()},
          "agreement_batch32": agreement,
          "serve_artifact": {"requests": len(bodies), "clients": 4,
                             "ready_s": served["ready_s"],
                             "batches_run": served["health"]["batches_run"],
                             "latency": served["health"]["latency"],
                             "model": served["health"]["model"], "log": served["log"]},
          "evaluate_export": {"images": 64, "batch": 32, "wall_s": evaluate_export_s,
                              "anchor_f1_own_predictions": f1},
          "img_per_s_batch32": rates,
          "timing": "host clock, predict_batch on 32 PreparedImages (copy, forward, decode, "
                    "fetch, annotations), 10 rounds, in turns Predictor, ExportPredictor, "
                    "ExportPredictor, Predictor",
          "launches": launches})
    return launches


def _int_mm_rules() -> dict:
    """Which operands `torch._int_mm` takes on this card and build: each
    case against the exact product (float64 on the CPU): 'equal', 'WRONG'
    or the error it raises. The port's wrapper passes only contiguous
    (M, K) and (K, N) operands with M > 16 and K, N multiples of 8."""
    import torch

    g = torch.Generator().manual_seed(0)

    def r8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)

    cases = {f"rows {m}, K {k}, N {n}": (r8(m, k), r8(k, n))
             for m in (4, 16, 17, 20, 24, 32, 40, 48, 64, 256) for k, n in ((64, 32), (1152, 128))}
    cases.update({"K 12": (r8(32, 12), r8(12, 32)), "N 12": (r8(32, 64), r8(64, 12)),
                  "b column-major": (r8(32, 64), r8(32, 64).t()),
                  "a column-major": (r8(64, 32).t(), r8(64, 32))})
    out = {}
    for name, (a, b) in cases.items():
        want = (a.double() @ b.double()).to(torch.int32)
        try:
            got = torch._int_mm(a.cuda(), b.cuda())
            torch.cuda.synchronize()
            out[name] = "equal" if torch.equal(got.cpu(), want) else "WRONG"
        except RuntimeError as e:
            out[name] = "error: " + str(e).splitlines()[0][:160]
    return out


def _head_gap(got, want) -> float:
    """rmse over the reference's spread (JAX tests/test_int8.py's measure)."""
    return float((got - want).double().pow(2).mean().sqrt() / (want.double().std() + 1e-8))


def _int8_products_exact(pred, feed, small_maps: bool = False) -> list:
    """The im2col product on every int8 conv shape `pred`'s model runs on
    `feed`, exact against the CPU's float64 convolution of the same int8
    values, and with `small_maps` on maps of 16 rows or fewer, which take
    the padded path. Returns the shapes checked: [x, w, stride, padding,
    rows]."""
    import torch

    from structuredetector_tpu_torch.models.quantize import (
        int8_conv_nhwc,
        int8_conv_reference,
        int8_convs,
    )

    captured = {}

    def capture(module, args):
        x_q, _ = module.quantize_input(args[0])
        w_q, _ = module.int8_weight()
        key = (tuple(x_q.shape), tuple(w_q.shape), module.stride, module.padding)
        captured.setdefault(key, (x_q.permute(0, 2, 3, 1).contiguous(), w_q))

    hooks = [m.register_forward_pre_hook(capture) for m in int8_convs(pred.model)]
    pred.forward(feed)
    for h in hooks:
        h.remove()
    g = torch.Generator().manual_seed(1)
    small = {(4, 512, 3): (1, 2, 2, 512), (16, 256, 1): (1, 4, 4, 256), (8, 128, 3): (2, 2, 2, 128),
             (15, 64, 3): (1, 3, 5, 64)} if small_maps else {}
    for (rows, cin, k), shape in small.items():
        x_q = torch.randint(-127, 128, shape, dtype=torch.int8, generator=g).cuda()
        w_q = torch.randint(-127, 128, (cin, cin, k, k), dtype=torch.int8, generator=g).cuda()
        captured[("rows<=16",) + shape] = (x_q, w_q)
    shapes = []
    for key, (x_q, w_q) in captured.items():
        stride, padding = (key[2], key[3]) if key[0] != "rows<=16" else ((1, 1), (w_q.shape[2] // 2,) * 2)
        got = int8_conv_nhwc(x_q, w_q, stride, padding).cpu()
        want = int8_conv_reference(x_q.cpu(), w_q.cpu(), stride, padding)
        if not torch.equal(got, want):
            raise AssertionError(f"the int8 product differs from the CPU's at {key}")
        shapes.append([list(x_q.shape), list(w_q.shape), list(stride), list(padding),
                       int(x_q.shape[0] * got.shape[1] * got.shape[2])])
    return shapes


def phase_int8(card: str, tmp: Path, ckpt: Path, gt_dir: Path) -> dict:
    """The JAX package's benchmark configuration, int8 with calibrated
    static scales, in the port at full width, on the evaluate_detect
    checkpoint: `_int_mm`'s rules, and the port's im2col product exact
    against the CPU on every int8 conv shape of the model and on maps of
    16 rows or fewer; static scales calibrated on 16 images and the
    weights prequantized; the int8 forward at batch 32 and 128 beside
    the bf16 forward (CUDA events, in turns), peak memory, `predict_batch`
    img/s; the int8 head's gap from the bf16 head and anchor-peak
    agreement; kernel B counted on the int8 Predictor path and kernel A
    on `cli.evaluate --int8`; a `convert_export --int8 --calibrate_dir`
    artifact through `evaluate_export`; a small fp32 int8 model on the
    card against the CPU. Returns the launch counts of the main path and
    the static-scale int8 forward's ms at batch 32."""
    import numpy as np
    import torch
    from PIL import Image

    from structuredetector_tpu_torch.cli import convert_export, evaluate, evaluate_export
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.data.augment import PredictionTransformation
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.models.quantize import (
        calibrate_activation_scales,
        int8_convs,
        prequantize_variables,
    )
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.predictor import Predictor, PreparedImage

    labels = ROOT / "labels.json"
    cfg = Config(labels_path=labels, pretrained_model=ckpt).finalize()
    cfg8 = dataclasses.replace(cfg, int8=True)
    bf16, int8 = Predictor(cfg, device="cuda"), Predictor(cfg8, device="cuda")
    if len(int8_convs(int8.model)) != 42:
        raise AssertionError("the int8 model must have 42 int8 convs")
    images = [Image.open(p).convert("RGB") for p in sorted((tmp / "images").glob("*.png"))]

    shapes = _int8_products_exact(int8, int8.to_device([int8.transform(images[0])]),
                                  small_maps=True)

    # batch-32 feeds; calibration on 16 images, normalized on the host as
    # convert_export --calibrate_dir does
    u8 = [int8.transform(im) for im in images[:32]]
    feed32 = int8.to_device(u8)
    feed128 = int8.to_device(u8 * 4)
    with torch.inference_mode():
        dynamic_ms = time_ms(lambda: int8.forward(feed32), iters=10, warmup=2)
    host = PredictionTransformation(cfg8, device_normalize=False)
    cal = torch.from_numpy(np.stack([host(im) for im in images[:16]])).cuda()
    calibrate_activation_scales(int8.model, [cal.permute(0, 3, 1, 2).contiguous()])
    prequantize_variables(int8.model)
    if any(m.act_scale is None or m.weight.dtype != torch.int8
           for m in int8_convs(int8.model)):
        raise AssertionError("calibration or prequantization left a conv out")

    with torch.inference_mode():
        fwd = {b: _in_turns({"bf16": lambda f=f: bf16.forward(f), "int8": lambda f=f: int8.forward(f)},
                            lambda fn: time_ms(fn, iters=10, warmup=2))
               for b, f in ((32, feed32), (128, feed128))}
        peak = {}
        for name, pred in (("bf16", bf16), ("int8", int8)):
            for b, f in ((32, feed32), (128, feed128)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                pred.forward(f)
                torch.cuda.synchronize()
                peak[f"{name} batch {b}"] = {"max_allocated": torch.cuda.max_memory_allocated(),
                                             "above_resident": torch.cuda.max_memory_allocated() - base}
        h16, h8 = bf16.forward(feed32), int8.forward(feed32)
        # where the int8 forward's device time goes: a profiler trace
        trace = _device_busy(lambda: int8.forward(feed32), fwd[32]["int8"]["mean"], top=12)
    gaps = {name: _head_gap(h8[:, ch], h16[:, ch]) for name, ch in (
        ("anchor_hm", slice(0, cfg.n_labels)), ("part_hm", slice(cfg.n_labels, cfg.n_labels + cfg.n_parts)),
        ("offsets", slice(-4, -2)), ("embeddings", slice(-2, None)))}
    a8, a16 = h8[:, : cfg.n_labels].flatten(2).argmax(-1), h16[:, : cfg.n_labels].flatten(2).argmax(-1)
    peak_agreement = float((a8 == a16).float().mean())
    prepared = [PreparedImage(a, im.size) for a, im in zip(u8, images)]
    rates = _in_turns({"bf16": bf16.predict_batch, "int8": int8.predict_batch},
                      lambda fn: _img_per_s(fn, prepared))

    common = ["--labels", str(labels), "--load_model", str(ckpt), "--eval_batch_size", "32",
              "--num_workers", "4", "--conf_threshold", "0.1"]
    # --- the main path: counts set to 0 just before, read just after
    reset_launch_counts()
    anns = int8.predict_batch(images[:32])
    after_predict = launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ev8 = evaluate.main(["--valid_dir", str(gt_dir), "--int8", "--save_summary",
                             str(tmp / "int8.json"), *common])[0.1]
        torch.cuda.synchronize()
        evaluate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        artifact = convert_export.main([str(ckpt), "-o", str(tmp / "int8_static.sdz"), "--params",
                                        str(labels), "--int8", "--calibrate_dir",
                                        str(tmp / "images"), "--calibrate_images", "16",
                                        "--batch_size", "32"])
        convert_s = time.perf_counter() - t0
        ev_export = evaluate_export.main([str(artifact), "--valid_dir", str(gt_dir),
                                          "--conf_threshold", "0.1", "--num_workers", "4"])
    torch.cuda.synchronize()
    launches = launch_counts()
    # --- end of the main path
    if not after_predict["sigmoid_nms_topk"]:
        raise AssertionError(f"the int8 Predictor did not launch kernel B: {after_predict}")
    if not launches["sigmoid_nms"] - after_predict["sigmoid_nms"]:
        raise AssertionError(f"evaluate --int8 did not launch kernel A: {launches}")
    if len(anns) != 32:
        raise AssertionError("the int8 predict_batch lost images")
    f1 = {"evaluate --int8": {k: e.f1_score for k, e in ev8.anchor_eval.items() if e.npos or e.ndet},
          "evaluate_export int8 static": {k: e.f1_score for k, e in ev_export.anchor_eval.items()
                                          if e.npos or e.ndet}}
    for name, v in f1.items():
        if not v or not all(math.isfinite(x) for x in v.values()):
            raise AssertionError(f"{name}: anchor F1 {v}")

    # a small fp32 int8 model on the card against the same model on the
    # CPU, same weights and images: every int8 conv, fed the input it got
    # on the card, gives the card's output on the CPU bit for bit (the
    # quantization, the exact product and the dequantization are the same
    # IEEE operations on both); the whole model's gap is recorded
    small_cfg = Config(width=128, height=128, fpn_depth=32, use_amp=False, int8=True,
                       labels_path=labels).finalize()
    gpu, cpu = init_model(small_cfg).cuda(), init_model(small_cfg)
    fp32 = init_model(dataclasses.replace(small_cfg, int8=False))
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (4, 3, 128, 128)).astype(np.float32))
    seen = []
    hooks = [m.register_forward_hook(lambda m, args, out: seen.append((m, args[0], out)))
             for m in int8_convs(gpu)]
    with torch.inference_mode():
        h_gpu = gpu(x.cuda(), raw_output=True).cpu()
        for h in hooks:
            h.remove()
        cpu_convs = dict(zip(int8_convs(gpu), int8_convs(cpu)))
        layers_equal = sum(torch.equal(cpu_convs[m](inp.cpu()), out.cpu()) for m, inp, out in seen)
        h_cpu, h_fp32 = cpu(x, raw_output=True), fp32(x, raw_output=True)
    card_vs_cpu = {"int8_layers_bit_identical": f"{layers_equal} of {len(seen)}",
                   "gap": _head_gap(h_gpu, h_cpu), "int8_vs_fp32_gap": _head_gap(h_cpu, h_fp32),
                   "bit_identical": bool(torch.equal(h_gpu, h_cpu)),
                   "max_rel": float((h_gpu - h_cpu).abs().max() / h_cpu.abs().max())}

    emit({"phase": "int8", "card": card,
          "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height}, int8 convs "
                   "(42: blocks, downsamples, FPN; stem and head bf16), static scales "
                   "calibrated on 16 images, prequantized weights; the evaluate_detect checkpoint",
          "int_mm_rules": _int_mm_rules(), "int8_product_exact_shapes": shapes,
          "forward_ms": fwd, "int8_dynamic_forward_ms_batch32": dynamic_ms,
          "int8_forward_trace_batch32": trace,
          "peak_memory_bytes": peak,
          "timing": "CUDA events, mean of 10 forwards after 2 warm-up, uint8 feed on the card, "
                    "in turns bf16, int8, int8, bf16; img/s on the host clock, 10 rounds of "
                    "predict_batch on 32 PreparedImages",
          "predict_batch_img_per_s_batch32": rates,
          "head_gap_int8_vs_bf16_batch32": gaps, "anchor_peak_agreement": peak_agreement,
          "objects_int8_batch32": sum(len(a.objects) for a in anns),
          "evaluate_int8_wall_s": evaluate_s, "convert_export_int8_calibrated_s": convert_s,
          "anchor_f1_own_predictions": f1,
          "card_vs_cpu_int8_small_fp32": {"config": "128x128 fpn_depth=32 fp32 (TF32 off), batch 4",
                                          **card_vs_cpu},
          "launches": launches, "launches_int8_predictor": after_predict})
    # JAX tests/test_int8.py:84's bar on the int8 model's gap from float
    if max(gaps.values()) > 0.25:
        raise AssertionError(f"int8 head departs from bf16: {gaps}")
    # card against CPU: each int8 conv is bit-identical on the same input;
    # the whole model is not, because the fp32 stem and BN differ by ulps
    # and an int8 rounding flip they cause moves an activation by one step
    # (1/127 of its range) and compounds (0.94 of the int8-vs-fp32 gap
    # measured on this card; the CPU tests measure such cascades up to
    # 1.06 of it against the JAX package): the bar is 1.5 times that gap
    if layers_equal != len(seen) or len(seen) != 42:
        raise AssertionError(f"an int8 conv differs between card and CPU: {card_vs_cpu}")
    if card_vs_cpu["gap"] > 1.5 * card_vs_cpu["int8_vs_fp32_gap"]:
        raise AssertionError(f"int8 on the card departs from int8 on the CPU: {card_vs_cpu}")
    return launches, fwd[32]["int8"]["mean"]


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


def _device_busy(step, ms_per_step: float, n: int = 3, top: int = 5) -> dict:
    """A torch.profiler (CUPTI) trace of `n` steps: the card's busy ms a
    step (kernels, copies and sets; no annotation ranges), its idle share
    of the unprofiled step time `ms_per_step`, and the `top` kernels that
    take most of it."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms_per_step": busy, "device_idle_share": 1.0 - busy / ms_per_step,
            "top_kernels_ms_per_step": [[name[:120], ms] for name, ms in ranked]}


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


DP_GLOBAL_BATCH = 32
DP_STEPS = 5


def _dp_config():
    """The data_parallel phase's step: the full-width main configuration
    (resnet34, fpn_depth 128, 512x512, labels.json) in fp32."""
    from structuredetector_tpu_torch.config import Config

    return Config(labels_path=ROOT / "labels.json", use_amp=False).finalize()


def _dp_steps(cfg, world: int, rank: int) -> dict:
    """DP_STEPS train steps (device augmentation, uint8 feed) of the seeded
    model on rank `rank`'s slice of the global batch of DP_GLOBAL_BATCH:
    every slot filled, then half of the last quarter's samples (half of
    rank 1's of 2) without a valid keypoint. The losses, ms a step (host
    clock over steps 2-5, synchronized), the gradient and the BN running
    statistics after step 1, the state after the last step (on the CPU)."""
    import torch

    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    images, kp = _train_batch(cfg, DP_GLOBAL_BATCH, seed=11, normalized=False)
    for name in ("anchor_mask", "part_mask"):
        kp[name][3 * DP_GLOBAL_BATCH // 4:] = False
    local = DP_GLOBAL_BATCH // world
    part = slice(rank * local, (rank + 1) * local)
    images, kp = images[part].contiguous(), {k: v[part].contiguous() for k, v in kp.items()}
    model = init_model(cfg).cuda()
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    out = {"losses": []}
    for i in range(DP_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out["losses"].append(float(train_step(state, images, kp, cfg, augment=True)
                                   ["total_loss"]))
        if i == 0:
            out["grad1"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            out["stats1"] = {n: b.detach().cpu().clone() for n, b in model.named_buffers()
                             if n.endswith(("running_mean", "running_var"))}
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / (DP_STEPS - 1)
    out["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return out


def _dp_rank(out: Path) -> None:
    """One rank of the data_parallel step: joins the group from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR/MASTER_PORT) and saves its `_dp_steps` to `out`."""
    import torch
    import torch.distributed as dist

    from structuredetector_tpu_torch.parallel.mesh import maybe_initialize_distributed

    if not maybe_initialize_distributed("cuda"):
        raise RuntimeError("no torchrun environment")
    result = _dp_steps(_dp_config(), dist.get_world_size(), dist.get_rank())
    result["backend"] = dist.get_backend()
    result["device"] = str(torch.cuda.current_device())
    dist.destroy_process_group()
    torch.save(result, out)


def _dp_cli_rank(out: Path, argv) -> None:
    """One rank of `cli.train` under torchrun, in `out/cwd<RANK>`: the
    launch counts of its process into `out/launches<RANK>.json`."""
    from structuredetector_tpu_torch.cli import train
    from structuredetector_tpu_torch.ops.kernels import launch_counts

    rank = os.environ["RANK"]
    with _cwd(out / f"cwd{rank}"):
        train.main(argv)
    (out / f"launches{rank}.json").write_text(json.dumps(launch_counts()))


def _run_ranks(tmp: Path, world: int, timeout_s: float = 300, case: str = None) -> list:
    """`world` processes of `_dp_rank` (or of `_ma_rank`'s `case`) with
    torchrun's environment, one host, ranks cuda:(LOCAL_RANK %
    device_count); their results by rank."""
    import subprocess

    import torch

    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                       "--dp_rank_out", str(tmp / f"rank{r}.pt"),
                                       *(["--ma_case", case] if case else [])],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=timeout_s)
            if proc.returncode:
                failures.append(f"rank {r}: exit {proc.returncode}\n{err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if failures:
        raise AssertionError(f"{case or 'data_parallel'} ranks: " + "\n".join(failures))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rel_gap(got: dict, want: dict, keys) -> float:
    """The largest over `keys` of max |got - want| / max |want|."""
    return max(float((got[k].double() - want[k].double()).abs().max()
                     / want[k].double().abs().max().clamp_min(1e-30)) for k in keys)


def _dp_compare(ranks: list, one: dict, lr: float) -> dict:
    """The 2-rank step against one process on the joined batch."""
    import torch

    first, second = ranks
    params = list(one["grad1"])
    grad_scale = max(float(g.abs().max()) for g in one["grad1"].values())
    return {
        "ranks_identical": all(torch.equal(first["state"][k], second["state"][k])
                               for k in first["state"]) and first["losses"] == second["losses"],
        "losses_2_ranks": first["losses"], "losses_1_process": one["losses"],
        "step0_loss_rel_gap": abs(first["losses"][0] - one["losses"][0]) / abs(one["losses"][0]),
        "loss_max_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(first["losses"],
                                                                   one["losses"])),
        "step1_grad_gap_of_largest": max(float((first["grad1"][k] - one["grad1"][k]).abs().max())
                                         for k in params) / grad_scale,
        "step1_bn_stats_max_rel_gap": _rel_gap(first["stats1"], one["stats1"], one["stats1"]),
        "params_max_rel_gap": _rel_gap(first["state"], one["state"], params),
        "params_max_abs_gap": max(float((first["state"][k] - one["state"][k]).abs().max())
                                  for k in params),
        "adam_bound": 2 * lr * DP_STEPS,
        "bn_stats_max_rel_gap": _rel_gap(first["state"], one["state"], one["stats1"]),
    }


def phase_data_parallel(card: str) -> dict:
    """Data parallelism on the one card: (1) two ranks share it over gloo,
    launched here with torchrun's environment, for DP_STEPS fp32 steps at
    full width and global batch 32 (device augmentation, uint8 feed, half
    of rank 1's samples without a valid keypoint), against one process on
    the joined batch; (2) `torchrun --nproc_per_node 2 -m
    structuredetector_tpu_torch.cli.train --data_parallel 2` (through
    `_dp_cli_rank`) for 2 epochs on the train phase's 64 + 16 annotated
    PNGs: rank 0 alone writes `trainings/`, kernel A is launched on each
    rank in validation, `cli.evaluate` loads its `model_best_loss.msgpack`;
    (3) a one-rank NCCL group with one all_reduce, and the 2-rank step on
    NCCL where there are two cards or more. Returns kernel launches of the
    `cli.train` ranks (fresh processes: their counts start at 0 with the
    run), summed."""
    import subprocess

    import torch
    import torch.distributed as dist

    from structuredetector_tpu_torch.cli import evaluate

    t_phase = time.perf_counter()
    labels = ROOT / "labels.json"
    cfg = _dp_config()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="sdnet-dp-") as tmp:
        tmp = Path(tmp)
        # (1) the step: two ranks on one card, then one process
        t0 = time.perf_counter()
        ranks = _run_ranks(tmp, 2)
        ranks_s = time.perf_counter() - t0
        one = _dp_steps(cfg, 1, 0)
        step = _dp_compare(ranks, one, cfg.learning_rate)
        backends = [r["backend"] for r in ranks]
        step.update({"backends": backends, "devices": [r["device"] for r in ranks],
                     "ms_per_step_2_ranks_sharing_one_card": ranks[0]["ms_per_step"],
                     "ms_per_step_1_process": one["ms_per_step"], "ranks_wall_s": ranks_s})
        del ranks, one
        emit({"phase": "data_parallel", "part": "step", "card": card,
              "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height} "
                       f"fp32 (TF32 off), global batch {DP_GLOBAL_BATCH}, {DP_STEPS} steps, "
                       "device augment (uint8 feed), half of rank 1's samples without a "
                       "valid keypoint, seeded init",
              "timing": "host clock over steps 2-5, synchronized; 2 ranks sharing one card "
                        "over gloo, not a scaling figure", **step})
        # bars stated in PERF.md: the ranks equal; the first step (a forward
        # and a backward of the same weights; cuDNN may pick other fp32
        # algorithms at batch 16 than at 32) within 1e-4; the parameters
        # within Adam's bound, 2 * lr a step. Adam moves a parameter whose
        # gradient is rounding noise (a BN bias the next BN cancels) by
        # about lr either way, and the trajectory follows: 9.1e-4 apart at
        # step 5 on the H100 (PERF.md), so it is held to 1e-2
        if backends != ["gloo", "gloo"] and cards == 1:
            raise AssertionError(f"two ranks on one card must use gloo: {backends}")
        if not step["ranks_identical"]:
            raise AssertionError("the two ranks' states differ")
        bad = {k: step[k] for k, bar in (("step0_loss_rel_gap", 1e-4),
                                         ("step1_grad_gap_of_largest", 1e-4),
                                         ("step1_bn_stats_max_rel_gap", 1e-4),
                                         ("loss_max_rel_gap", 1e-2),
                                         ("params_max_abs_gap", step["adam_bound"]))
               if not step[k] <= bar}
        if bad:
            raise AssertionError(f"2 ranks depart from one process on the joined batch: {bad}")

        # (2) cli.train under torchrun
        _write_annotated(tmp / "train", 64, seed=1)
        _write_annotated(tmp / "valid", 16, seed=2)
        cli = tmp / "cli"
        for r in (0, 1):
            (cli / f"cwd{r}").mkdir(parents=True)
        argv = ["--data_parallel", "2", "--train_dir", str(tmp / "train"), "--valid_dir",
                str(tmp / "valid"), "--labels", str(labels), "--epochs", "2",
                "--eval_batch_size", "16", "--num_workers", "4"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"),
                               "--dp_cli_out", str(cli), "--", *argv],
                              capture_output=True, text=True, timeout=400)
        cli_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"torchrun cli.train: exit {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        launches = [json.loads((cli / f"launches{r}.json").read_text()) for r in (0, 1)]
        written = {r: sorted(str(p.relative_to(cli / f"cwd{r}"))
                             for p in (cli / f"cwd{r}").iterdir()) for r in (0, 1)}
        runs = list((cli / "cwd0" / "trainings").iterdir())
        snapshot = runs[0] / "model_best_loss.msgpack" if len(runs) == 1 else None
        backend_lines = [l for l in proc.stdout.splitlines() if l.startswith("Process group:")]
        if written[1] or written[0] != ["trainings"] or snapshot is None \
                or not snapshot.exists():
            raise AssertionError(f"only rank 0 writes one run: {written}, {runs}")
        if not all(counts["sigmoid_nms"] for counts in launches):
            raise AssertionError(f"kernel A not launched on each rank: {launches}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            evaluators = evaluate.main([
                "--valid_dir", str(tmp / "valid"), "--labels", str(labels), "--load_model",
                str(snapshot), "--eval_batch_size", "16",
                "--save_summary", str(tmp / "summary.json")])
        evaluate_s = time.perf_counter() - t0
        summary = json.loads((tmp / "summary.json").read_text())
        if not evaluators or not all(math.isfinite(v) for v in summary.values()):
            raise AssertionError(f"cli.evaluate on the 2-rank checkpoint: {summary}")

        # (3) NCCL: a one-rank group on the card, one all_reduce
        dist.init_process_group("nccl", init_method=f"file://{tmp / 'nccl-store'}",
                                world_size=1, rank=0)
        try:
            value = torch.full((4,), 3.0, device="cuda")
            dist.all_reduce(value)
            torch.cuda.synchronize()
            nccl_ok = value.tolist() == [3.0] * 4
            nccl_version = ".".join(map(str, torch.cuda.nccl.version()))
        finally:
            dist.destroy_process_group()
        if not nccl_ok:
            raise AssertionError(f"one-rank NCCL all_reduce gave {value.tolist()}")
        if cards >= 2:
            (tmp / "nccl").mkdir()
            multi = _run_ranks(tmp / "nccl", 2)
            nccl_multi = {**_dp_compare(multi, _dp_steps(cfg, 1, 0), cfg.learning_rate),
                          "backends": [r["backend"] for r in multi],
                          "ms_per_step_2_cards": multi[0]["ms_per_step"]}
            if nccl_multi["backends"] != ["nccl", "nccl"] or not nccl_multi["ranks_identical"]:
                raise AssertionError(f"2-rank step on NCCL: {nccl_multi}")
        else:
            nccl_multi = f"not run: {cards} card"
    total = {k: sum(counts[k] for counts in launches) for k in launches[0]}
    emit({"phase": "data_parallel", "part": "cli_and_nccl", "card": card,
          "cli_train": {"command": "torchrun --standalone --nproc_per_node 2 -m "
                                   "structuredetector_tpu_torch.cli.train --data_parallel 2",
                        "train_images": 64, "valid_images": 16, "epochs": 2,
                        "global_batch_size": 8, "wall_s": cli_s, "backend": backend_lines,
                        "written_by_rank": written, "launches_by_rank": launches},
          "cli_evaluate_wall_s": evaluate_s,
          "evaluate_summary": {k: summary[k] for k in ("anchor/f1_total", "kps/f1_total")},
          "nccl_one_rank_all_reduce": nccl_ok, "nccl_version": nccl_version,
          "nccl_multi_card": nccl_multi, "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


MA_GLOBAL_BATCH = 4
MA_STEPS = 3
MA_ROW_BATCH = 2


def _as_float64(module, args):
    return (args[0].double(), *args[1:])


def _ma_steps(cfg, mesh, spatial: bool, steps: int, float64: bool = False) -> dict:
    """`steps` fp32 train steps (device augmentation, uint8 feed) of the
    seeded model on `mesh` (None: one process), each rank on its data
    index's slice of a global batch of MA_GLOBAL_BATCH, the model sharded
    over the model axis unless `spatial` (rows over it then): the losses,
    the gradient and BN statistics after step 1 and the state after the
    last, whole, on the CPU; ms a step (host clock over steps 2 on,
    synchronized), the peak memory of this process, the parameter and
    BN-statistic elements this rank holds and their share by the rule.
    `float64`: one process with the network in float64 (the augmented
    batch cast to it, the loss in float32), the yardstick of float32's
    reduction orders."""
    import torch

    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.parallel.mesh import shards_on_cout
    from structuredetector_tpu_torch.parallel.partition import shard_model
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    torch.cuda.reset_peak_memory_stats()
    images, kp = _train_batch(cfg, MA_GLOBAL_BATCH, seed=13, normalized=False)
    index, ranks = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)
    local = MA_GLOBAL_BATCH // ranks
    part = slice(index * local, (index + 1) * local)
    images, kp = images[part].contiguous(), {k: v[part].contiguous() for k, v in kp.items()}
    model = init_model(cfg).cuda()
    model_size = mesh.model if mesh is not None and not spatial else 1
    params = dict(model.named_parameters())
    share = {"params": 0, "batch_stats": 0}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        split = shards_on_cout(name, tuple(t.shape), model_size)
        share["params" if name in params else "batch_stats"] += \
            t.numel() // (model_size if split else 1)
    plan = shard_model(model, mesh) if model_size > 1 else None
    if float64:
        model.double().register_forward_pre_hook(_as_float64)
    whole = plan.full_state_dict if plan is not None else dict
    state = create_train_state(cfg, model, steps_per_epoch=1000, partition=plan)
    out = {"losses": [], "elements_expected": share, "elements": {
        "params": sum(p.numel() for p in model.parameters()),
        "batch_stats": sum(b.numel() for n, b in model.named_buffers()
                           if n.endswith(("running_mean", "running_var")))}}
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out["losses"].append(float(train_step(state, images, kp, cfg, augment=True, mesh=mesh,
                                              spatial=spatial)["total_loss"]))
        if i == 0:
            grad = whole({n: p.grad.detach() for n, p in model.named_parameters()})
            out["grad1"] = {k: v.float().cpu() for k, v in grad.items()}
            stats = whole({n: b.detach().clone() for n, b in model.named_buffers()
                           if n.endswith(("running_mean", "running_var"))})
            out["stats1"] = {k: v.float().cpu() for k, v in stats.items()}
    torch.cuda.synchronize()
    if steps > 1:
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    out["state"] = {k: v.cpu() for k, v in state.state_dict()["model"].items()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _dropped_halo_grad(ctx, g):
    """`_Halo.backward` that drops the halo rows' gradients instead of
    returning them to the ranks that own those rows."""
    return g.narrow(2, ctx.top, ctx.h).contiguous(), None, None, None, None


def _summed_gather_grad(ctx, g):
    """`_Gather.backward` that always sums over the group: where every rank
    holds the same whole gradient (the gathered head output) it scales
    the gradient by the ranks' count."""
    from structuredetector_tpu_torch.parallel import partition

    g = partition._summed(g, ctx.plan.group)
    return g.narrow(ctx.dim, ctx.plan.index * ctx.local, ctx.local), None, None, None


# faults planted in the spatial backward, which (c)'s gradient bar must
# refuse: (the autograd Function of parallel.partition, its wrong backward)
MA_FAULTS = {"dropped_halo_grad": ("_Halo", _dropped_halo_grad),
             "summed_gather_grad": ("_Gather", _summed_gather_grad)}


def _ma_forward_batch(cfg):
    """The row forward's ImageNet-normalized (B, H, W, 3) batch on the card."""
    return _train_batch(cfg, MA_ROW_BATCH, seed=17, normalized=True)[0].contiguous()


def _ma_decode(maps, cfg):
    from structuredetector_tpu_torch.ops.decode import decode_feature_maps_planes

    return decode_feature_maps_planes(maps, max_objects=cfg.max_objects,
                                      max_parts=cfg.max_parts, conf_thresh=cfg.conf_threshold,
                                      dist_thresh=cfg.decoder_dist_thresh)


# (e)'s cases of `make_sharded_forward` on the 1 x 2 mesh: (batch, the
# model sharded by `shard_model`, spatial)
MA_TP_FORWARDS = {"plain_b1": (1, False, False), "plain_b2": (2, False, False),
                  "sharded_b2": (2, True, False), "sharded_spatial_b2": (2, True, True)}


def _ma_tp_forwards(cfg) -> dict:
    """(e)'s rank: `make_sharded_forward` of the seeded model on
    `create_mesh(1, 2)` for each `MA_TP_FORWARDS` case, on the first rows
    of the row forward's batch: the four maps, ms (median of 5 after one
    warm-up, host clock, synchronized) and the decode of the maps through
    kernel B, its launches counted from 0 at the case's start."""
    import torch
    import torch.distributed as dist

    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.parallel.mesh import create_mesh
    from structuredetector_tpu_torch.parallel.partition import shard_model
    from structuredetector_tpu_torch.train.steps import make_sharded_forward

    mesh = create_mesh(1, 2, "cuda")
    images = _ma_forward_batch(cfg)
    out = {}
    for name, (batch, shard, spatial) in MA_TP_FORWARDS.items():
        reset_launch_counts()
        model = init_model(cfg).cuda()
        plan = shard_model(model, mesh) if shard else None
        forward = make_sharded_forward(model, mesh, spatial=spatial, partition=plan)
        x = images[:batch].contiguous()
        maps = forward(x)  # cuDNN's first use of each shape
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            maps = forward(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        decoded = _ma_decode(maps, cfg)
        torch.cuda.synchronize()
        out[name] = {"ms": sorted(times)[2], "ms_runs": times, "launches": launch_counts(),
                     "maps": {k: v.cpu() for k, v in maps.items()},
                     "decoded": {k: v.cpu() for k, v in decoded.items()}}
        del model, forward, maps
        torch.cuda.empty_cache()
    return out


def _ma_rank(out: Path, case: str) -> None:
    """One rank of the model_axis phase, joined from torchrun's environment:
    "tp" (2 ranks) the 1 x 2 tensor-parallel steps; "tp_forward" (2 ranks)
    `_ma_tp_forwards`; "rows" (4 ranks) the
    1 x 4 row forward at batch MA_ROW_BATCH and the decode of its gathered
    maps (kernel B, counted from 0 here), then the 2 x 2 spatial step,
    clean and with each `MA_FAULTS` fault planted."""
    import torch
    import torch.distributed as dist

    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.parallel import partition
    from structuredetector_tpu_torch.parallel.mesh import create_mesh, maybe_initialize_distributed
    from structuredetector_tpu_torch.train.steps import make_sharded_forward

    if not maybe_initialize_distributed("cuda"):
        raise RuntimeError("no torchrun environment")
    cfg = _dp_config()
    result = {"backend": dist.get_backend(), "device": str(torch.cuda.current_device())}
    if case == "tp":
        result.update(_ma_steps(cfg, create_mesh(1, 2, "cuda"), False, MA_STEPS))
    elif case == "tp_forward":
        result.update(_ma_tp_forwards(cfg))
    elif case == "rows":
        images = _ma_forward_batch(cfg)
        forward = make_sharded_forward(init_model(cfg).cuda(), create_mesh(1, 4, "cuda"),
                                       spatial=True)
        maps = forward(images)  # cuDNN's first use of each shape
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            maps = forward(images)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        reset_launch_counts()
        decoded = _ma_decode(maps, cfg)
        torch.cuda.synchronize()
        result.update(forward_ms=sorted(times)[len(times) // 2], forward_ms_runs=times,
                      launches=launch_counts(),
                      maps={k: v.cpu() for k, v in maps.items()},
                      decoded={k: v.cpu() for k, v in decoded.items()})
        grid = create_mesh(2, 2, "cuda")
        result["spatial"] = _ma_steps(cfg, grid, True, 1)
        for fault, (name, backward) in MA_FAULTS.items():
            fn = getattr(partition, name)
            right = fn.__dict__["backward"]
            fn.backward = staticmethod(backward)
            try:
                result[fault] = _ma_steps(cfg, grid, True, 1)
            finally:
                fn.backward = right
    else:
        raise SystemExit(f"unknown model_axis case {case}")
    if dist.get_rank():  # the whole tensors are compared on rank 0's copy
        for run in (result, *(result.get(k, {}) for k in ("spatial", *MA_FAULTS))):
            for key in ("grad1", "state", "maps"):
                run.pop(key, None)
    dist.destroy_process_group()
    torch.save(result, out)


def _anchor_f1(a: dict, b: dict) -> float:
    """F1 of the anchors of two decodes of the same images: the K anchors
    of each image (x, y, score, label), one matched to one of the same
    label within half a grid cell."""
    tp = n = 0
    for x, y in zip(a["anchors"], b["anchors"]):
        free = [True] * len(y)
        for ax, ay, _, al in x.tolist():
            for j, (bx, by, _, bl) in enumerate(y.tolist()):
                if free[j] and al == bl and (ax - bx) ** 2 + (ay - by) ** 2 <= 0.25:
                    free[j] = False
                    tp += 1
                    break
        n += len(x) + len(y)
    return 2 * tp / max(n, 1)


def _ma_grad_gap(got: dict, want: dict):
    """max |got - want| over the gradient's largest element, and the tensor
    where it is."""
    scale = max(float(g.abs().max()) for g in want.values())
    gaps = {k: float((got[k] - v).abs().max()) / scale for k, v in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _ma_first_step(got: dict, one: dict, f64: dict) -> dict:
    """A mesh run's first step and parameters against one process's, and
    both first-step gradients against the float64 one's."""
    params = list(one["grad1"])
    gap, worst = _ma_grad_gap(got["grad1"], one["grad1"])
    return {
        "step0_loss_rel_gap": abs(got["losses"][0] - one["losses"][0]) / abs(one["losses"][0]),
        "step1_grad_gap_of_largest": gap, "step1_grad_worst": worst,
        "step1_grad_gap_to_float64": _ma_grad_gap(got["grad1"], f64["grad1"])[0],
        "one_process_grad_gap_to_float64": _ma_grad_gap(one["grad1"], f64["grad1"])[0],
        "step1_bn_stats_max_rel_gap": _rel_gap(got["stats1"], one["stats1"], one["stats1"]),
        "params_max_abs_gap": max(float((got["state"][k] - one["state"][k]).abs().max())
                                  for k in params),
    }


def _ma_grad_bar(step: dict) -> float:
    """(c)'s gradient bar against the float64 step: 1e-4, or twice one
    process's own distance from it (PERF.md §6: split BN sums and other
    cuDNN shapes reorder float32 sums)."""
    return max(1e-4, 2 * step["one_process_grad_gap_to_float64"])


def phase_model_axis(card: str) -> dict:
    """The mesh's model axis on the one card, ranks sharing it over gloo,
    launched with torchrun's environment, at full width (resnet34,
    fpn_depth 128, 512x512, labels.json, seeded weights, fp32 with TF32
    off): (a) the 1 x 2 tensor-parallel step (`--model_parallel 2`'s),
    MA_STEPS steps at global batch 4 against one process on the same
    batch, with each rank's parameter elements against the rule of JAX's
    `param_shardings`, ms a step and peak memory a rank; (b) the row
    forward, `make_sharded_forward(spatial=True)` over 1 x 4 rows at batch
    2, against one forward (heads within 1e-4 of their scale), its
    gathered maps decoded through kernel B on every rank (anchor F1 of
    the two decodes at least 0.99); (c) the 2 x 2 spatial step's first
    step against the one process of (a) and a float64 step, and with
    each `MA_FAULTS` fault planted, which its gradient bar must refuse;
    (d) `torchrun --nproc_per_node 2
    -m structuredetector_tpu_torch.cli.train --model_parallel 2` for 2
    epochs of the train phase's 64 + 16 PNGs: kernel A launched on each
    rank in validation, rank 0 alone writing, `cli.evaluate` loading its
    `model_best_loss.msgpack` in one process; (e) `make_sharded_forward`
    on the 1 x 2 mesh (`_ma_tp_forward_part`), printed before (d)'s line,
    which carries the phase's totals. Returns the ranks' kernel launches
    of the main paths, (b)'s decode, (d) and (e), summed."""
    import subprocess

    import torch

    from structuredetector_tpu_torch.cli import evaluate
    from structuredetector_tpu_torch.models.network import init_model

    t_phase = time.perf_counter()
    labels = ROOT / "labels.json"
    cfg = _dp_config()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sdnet-ma-") as tmp:
        tmp = Path(tmp)
        # (a) the tensor-parallel step, then one process
        t0 = time.perf_counter()
        tp = _run_ranks(tmp, 2, case="tp")
        tp_s = time.perf_counter() - t0
        one = _ma_steps(cfg, None, False, MA_STEPS)
        f64 = _ma_steps(cfg, None, False, 1, float64=True)
        step = _ma_first_step(tp[0], one, f64)
        step.update({
            "ranks_identical": tp[0]["losses"] == tp[1]["losses"],
            "losses_2_ranks": tp[0]["losses"], "losses_1_process": one["losses"],
            "adam_bound": 2 * cfg.learning_rate * MA_STEPS,
            "elements_by_rank": [r["elements"] for r in tp],
            "elements_expected": [r["elements_expected"] for r in tp],
            "elements_1_process": one["elements"],
            "ms_per_step_2_ranks_sharing_one_card": [r["ms_per_step"] for r in tp],
            "ms_per_step_1_process": one["ms_per_step"],
            "peak_gb_by_rank": [r["peak_gb"] for r in tp], "peak_gb_1_process": one["peak_gb"],
            "backends": [r["backend"] for r in tp], "ranks_wall_s": tp_s})
        del tp
        emit({"phase": "model_axis", "part": "a_tensor_parallel_step", "card": card,
              "model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} {cfg.width}x{cfg.height} fp32 "
                       f"(TF32 off), 1 data x 2 model, global batch {MA_GLOBAL_BATCH}, "
                       f"{MA_STEPS} steps, device augment (uint8 feed), seeded init",
              "timing": "host clock over steps 2-3, synchronized; 2 ranks sharing one card "
                        "over gloo, not a scaling figure", **step})
        # bars stated in PERF.md before the first run
        bad = {k: step[k] for k, bar in (("step0_loss_rel_gap", 1e-4),
                                         ("step1_grad_gap_of_largest", 1e-4),
                                         ("step1_bn_stats_max_rel_gap", 1e-4),
                                         ("params_max_abs_gap", step["adam_bound"]))
               if not step[k] <= bar}
        if bad or not step["ranks_identical"] or step["backends"] != ["gloo", "gloo"]:
            raise AssertionError(f"the tensor-parallel step departs from one process: {bad}, "
                                 f"{step['ranks_identical']}, {step['backends']}")
        if step["elements_by_rank"] != step["elements_expected"] \
                or step["elements_by_rank"][0]["params"] >= one["elements"]["params"]:
            raise AssertionError(f"a rank's elements are not JAX's share: {step}")

        # (b) and (c): four ranks, the row forward then the spatial step
        t0 = time.perf_counter()
        rows = _run_ranks(tmp, 4, case="rows")
        rows_s = time.perf_counter() - t0
        images = _ma_forward_batch(cfg)
        model = init_model(cfg).cuda().eval()
        with torch.no_grad():
            want = model(images.permute(0, 3, 1, 2).contiguous())
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want = model(images.permute(0, 3, 1, 2).contiguous())
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        want = {k: v.cpu() for k, v in want.items()}
        one_decoded = {k: v.cpu() for k, v in _ma_decode({k: v.cuda() for k, v in want.items()},
                                                         cfg).items()}
        del model
        got = rows[0]["maps"]
        head_gap = max(float((got[k] - v).abs().max() / v.abs().max()) for k, v in want.items())
        f1 = [_anchor_f1(r["decoded"], one_decoded) for r in rows]
        row_launches = [r["launches"] for r in rows]
        spatial = _ma_first_step(rows[0]["spatial"], one, f64)
        spatial["ranks_identical"] = len({tuple(r["spatial"]["losses"]) for r in rows}) == 1
        grad_bar = _ma_grad_bar(spatial)
        faults = {f: _ma_first_step(rows[0][f], one, f64)["step1_grad_gap_to_float64"]
                  for f in MA_FAULTS}
        emit({"phase": "model_axis", "part": "b_row_forward_c_spatial_step", "card": card,
              "row_forward": {"mesh": "1 data x 4 rows", "batch": MA_ROW_BATCH,
                              "head_max_gap_of_scale": head_gap, "anchor_f1_by_rank": f1,
                              "ms_median_of_5": [r["forward_ms"] for r in rows],
                              "ms_runs_rank0": rows[0]["forward_ms_runs"],
                              "ms_1_process_fp32": sorted(times)[2],
                              "launches_by_rank": row_launches},
              "spatial_step": {"mesh": "2 data x 2 rows", "global_batch": MA_GLOBAL_BATCH,
                               "peak_gb_by_rank": [r["spatial"]["peak_gb"] for r in rows],
                               "grad_bar_to_float64": grad_bar,
                               "planted_faults_grad_gap_to_float64": faults, **spatial},
              "ranks_wall_s": rows_s,
              "timing": "host clock, synchronized, median of 5 after one warm-up; 4 ranks "
                        "sharing one card over gloo, not a scaling figure"})
        if head_gap > 1e-4 or min(f1) < 0.99:
            raise AssertionError(f"the row forward departs from one forward: {head_gap}, {f1}")
        if not all(c["sigmoid_nms_topk"] for c in row_launches):
            raise AssertionError(f"kernel B not launched on every rank: {row_launches}")
        bad = {k: spatial[k] for k, bar in (("step0_loss_rel_gap", 1e-4),
                                            ("step1_grad_gap_to_float64", grad_bar),
                                            ("step1_bn_stats_max_rel_gap", 1e-4))
               if not spatial[k] <= bar}
        if bad or not spatial["ranks_identical"]:
            raise AssertionError(f"the spatial step departs from one process: {bad}, "
                                 f"{spatial['ranks_identical']}")
        if not all(gap > grad_bar for gap in faults.values()):
            raise AssertionError(f"(c)'s bar {grad_bar} passes a planted fault: {faults}")
        del rows, one, f64

        # (d) cli.train --model_parallel 2 under torchrun
        _write_annotated(tmp / "train", 64, seed=1)
        _write_annotated(tmp / "valid", 16, seed=2)
        cli = tmp / "cli"
        for r in (0, 1):
            (cli / f"cwd{r}").mkdir(parents=True)
        argv = ["--model_parallel", "2", "--train_dir", str(tmp / "train"), "--valid_dir",
                str(tmp / "valid"), "--labels", str(labels), "--epochs", "2",
                "--eval_batch_size", "16", "--num_workers", "4"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "2", str(ROOT / "chip_smoke.py"),
                               "--dp_cli_out", str(cli), "--", *argv],
                              capture_output=True, text=True, timeout=400)
        cli_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"torchrun cli.train --model_parallel 2: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        launches = [json.loads((cli / f"launches{r}.json").read_text()) for r in (0, 1)]
        written = {r: sorted(str(p.relative_to(cli / f"cwd{r}"))
                             for p in (cli / f"cwd{r}").iterdir()) for r in (0, 1)}
        runs = list((cli / "cwd0" / "trainings").iterdir())
        snapshot = runs[0] / "model_best_loss.msgpack" if len(runs) == 1 else None
        if written[1] or written[0] != ["trainings"] or snapshot is None \
                or not snapshot.exists():
            raise AssertionError(f"only rank 0 writes one run: {written}, {runs}")
        if not all(counts["sigmoid_nms"] for counts in launches):
            raise AssertionError(f"kernel A not launched on each rank: {launches}")
        with contextlib.redirect_stdout(io.StringIO()):
            evaluators = evaluate.main([
                "--valid_dir", str(tmp / "valid"), "--labels", str(labels), "--load_model",
                str(snapshot), "--eval_batch_size", "16",
                "--save_summary", str(tmp / "summary.json")])
        summary = json.loads((tmp / "summary.json").read_text())
        if not evaluators or not all(math.isfinite(v) for v in summary.values()):
            raise AssertionError(f"cli.evaluate on the --model_parallel 2 checkpoint: {summary}")
        tp_forward = _ma_tp_forward_part(card, cfg, tmp)
    total = {k: sum(c[k] for c in launches + row_launches + tp_forward) for k in launches[0]}
    emit({"phase": "model_axis", "part": "d_cli_train", "card": card,
          "cli_train": {"command": "torchrun --standalone --nproc_per_node 2 -m "
                                   "structuredetector_tpu_torch.cli.train --model_parallel 2",
                        "train_images": 64, "valid_images": 16, "epochs": 2,
                        "global_batch_size": 8, "wall_s": cli_s,
                        "written_by_rank": written, "launches_by_rank": launches},
          "evaluate_summary": {k: summary[k] for k in ("anchor/f1_total", "kps/f1_total")},
          "launches": total, "seconds": time.perf_counter() - t_phase})
    return total


def _ma_tp_forward_part(card: str, cfg, tmp: Path) -> list:
    """(e) "tp_forward": `make_sharded_forward` without `spatial` on
    `create_mesh(1, 2)`, 2 ranks sharing the card over gloo: a plain model
    at batch 1 and 2, a `shard_model` model through its plan at batch 2,
    and that model with `spatial=True` at batch 2. Each rank's four maps
    within 1e-5 of each map's scale of one process's forward of the same
    batch on the card, its decode through kernel B (launched on each
    rank) with anchor F1 1.0 against one process's. Returns the ranks'
    launch counts, each case's summed."""
    import torch

    from structuredetector_tpu_torch.models.network import init_model

    t0 = time.perf_counter()
    ranks = _run_ranks(tmp, 2, case="tp_forward")
    ranks_s = time.perf_counter() - t0
    images = _ma_forward_batch(cfg)
    model = init_model(cfg).cuda().eval()
    want, want_decoded, one_ms = {}, {}, {}
    with torch.no_grad():
        for batch in sorted({b for b, _, _ in MA_TP_FORWARDS.values()}):
            x = images[:batch].permute(0, 3, 1, 2).contiguous()
            maps = model(x)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                maps = model(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            one_ms[batch] = sorted(times)[2]
            want[batch] = {k: v.cpu() for k, v in maps.items()}
            want_decoded[batch] = {k: v.cpu() for k, v in _ma_decode(maps, cfg).items()}
    del model
    cases, launches = {}, []
    for name, (batch, shard, spatial) in MA_TP_FORWARDS.items():
        runs = [r[name] for r in ranks]
        cases[name] = {
            "batch": batch, "sharded": shard, "spatial": spatial,
            "map_gap_of_scale_by_rank": [
                {k: float((r["maps"][k] - v).abs().max() / v.abs().max())
                 for k, v in want[batch].items()} for r in runs],
            "anchor_f1_by_rank": [_anchor_f1(r["decoded"], want_decoded[batch]) for r in runs],
            "ms_median_of_5_by_rank": [r["ms"] for r in runs],
            "ms_runs_rank0": runs[0]["ms_runs"], "ms_1_process_fp32": one_ms[batch],
            "launches_by_rank": [r["launches"] for r in runs]}
        launches += [r["launches"] for r in runs]
    emit({"phase": "model_axis", "part": "e_tp_forward", "card": card,
          "mesh": "1 data x 2 model", "cases": cases, "ranks_wall_s": ranks_s,
          "timing": "host clock, synchronized, median of 5 after one warm-up; 2 ranks "
                    "sharing one card over gloo, not a scaling figure"})
    bad = {name: c for name, c in cases.items()
           if max(max(g.values()) for g in c["map_gap_of_scale_by_rank"]) > 1e-5
           or min(c["anchor_f1_by_rank"]) < 1.0
           or not all(n["sigmoid_nms_topk"] for n in c["launches_by_rank"])}
    if bad:
        raise AssertionError(f"(e) make_sharded_forward on 1 x 2 departs from one process or "
                             f"did not decode through kernel B: {bad}")
    return launches


# the port's top-level names (JAX `__init__.py`'s), in its `__all__` order
LIBRARY_NAMES = ["Box", "Config", "ImageAnnotation", "Keypoint", "Object", "Predictor",
                 "ExportPredictor", "MicroBatcher", "Evaluator", "Trainer", "SDNet"]

_CLEAN_IMPORT = (
    "import json, sys\n"
    "import structuredetector_tpu_torch\n"
    "banned = ('jax', 'structuredetector_tpu', 'torch.utils.cpp_extension', "
    "'structuredetector_tpu_torch.parallel')\n"
    "print(json.dumps(sorted(m for m in sys.modules if any(m == b or m.startswith(b + '.') "
    "for b in banned))))\n"
)


def phase_library(card: str) -> dict:
    """The package API on the card: a clean import in a fresh process; every
    top-level name resolved; `structuredetector_tpu_torch.Predictor` at
    full width (resnet34, fpn_depth 128, 512x512, bf16, labels.json,
    seeded weights) predicting a batch of 32 (kernel B, counted); the
    seeded model through `save_reference_pth` and `load_weights` into a
    fresh SDNet, whose eval forward on the card must be bit-identical.
    Returns the Predictor path's launch counts."""
    import subprocess

    import numpy as np
    import torch
    from PIL import Image

    import structuredetector_tpu_torch as sdt
    from structuredetector_tpu_torch.models import build_model, load_weights, save_reference_pth
    from structuredetector_tpu_torch.ops.device_augment import normalize_images
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLEAN_IMPORT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"import structuredetector_tpu_torch: {proc.stderr[-2000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    if loaded:
        raise AssertionError(f"importing the package loaded {loaded}")
    if list(sdt.__all__) != LIBRARY_NAMES:
        raise AssertionError(f"the top-level names are {sdt.__all__}")
    resolved = {name: getattr(sdt, name).__module__ for name in LIBRARY_NAMES}
    proc = subprocess.run([sys.executable, "-c", _CLEAN_TOOLS_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"import structuredetector_tpu_torch.tools.*: {proc.stderr[-2000:]}")
    tools = json.loads(proc.stdout.strip().splitlines()[-1])
    if tools["banned"] or "accuracy_run" not in tools["modules"]:
        raise AssertionError(f"importing the tools: {tools}")

    cfg = sdt.Config(labels_path=ROOT / "labels.json").finalize()
    pixels = np.random.default_rng(23).integers(0, 256, (32, cfg.height, cfg.width, 3),
                                                np.uint8)
    reset_launch_counts()
    predictor = sdt.Predictor(cfg)
    annotations = predictor.predict_batch([Image.fromarray(p) for p in pixels])
    torch.cuda.synchronize()
    launches = launch_counts()
    if len(annotations) != 32 or not launches["sigmoid_nms_topk"]:
        raise AssertionError(f"Predictor through the top-level name: {len(annotations)} "
                             f"annotations, launches {launches}")
    model = predictor.model.eval()
    with tempfile.TemporaryDirectory(prefix="sdnet-library-") as tmp:
        path = save_reference_pth(model, Path(tmp) / "sdnet.pth")
        pth_mb = path.stat().st_size / 1e6
        fresh = load_weights(build_model(cfg), path).cuda().eval()
    feed = normalize_images(torch.from_numpy(pixels[:8]).cuda().float() / 255.0)
    feed = feed.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        a, b = model(feed, raw_output=True), fresh(feed, raw_output=True)
    identical = bool(torch.equal(a, b))
    emit({"phase": "library", "card": card, "clean_import": loaded == [],
          "tools_clean_import": tools, "resolved": resolved, "device": str(predictor.device),
          "predictor": {"model": f"SDNet resnet34 fpn_depth={cfg.fpn_depth} "
                                 f"{cfg.width}x{cfg.height} bf16, seeded init",
                        "batch": 32, "annotations": len(annotations),
                        "launches": launches},
          "reference_pth": {"mb": pth_mb, "forward_batch": 8, "bit_identical": identical},
          "seconds": time.perf_counter() - t_phase})
    if not identical:
        raise AssertionError("the .pth round trip changed the forward: "
                             f"{float((a - b).abs().max())}")
    return launches


_CLEAN_TOOLS_IMPORT = (
    "import importlib, json, pkgutil, sys\n"
    "import structuredetector_tpu_torch.tools as tools_pkg\n"
    "names = sorted(m.name for m in pkgutil.iter_modules(tools_pkg.__path__))\n"
    "for name in names:\n"
    "    importlib.import_module('structuredetector_tpu_torch.tools.' + name)\n"
    "banned = ('jax', 'structuredetector_tpu', 'tools')\n"
    "print(json.dumps({'modules': names, 'banned': sorted(m for m in sys.modules "
    "if any(m == b or m.startswith(b + '.') for b in banned))}))\n"
)


def _counted_module(out: Path, module: str, argv) -> None:
    """`module`'s `main(argv)` in this process (a subprocess of the accuracy
    phase's chain); its kernel launch counts go to `out/<pid>.json` when
    it returns, and when SIGTERM ends it (the load test stops its server
    so)."""
    import importlib
    import signal

    from structuredetector_tpu_torch.ops.kernels import launch_counts

    out.mkdir(parents=True, exist_ok=True)

    def write():
        (out / f"{os.getpid()}.json").write_text(json.dumps(launch_counts()))

    def on_term(signum, frame):
        write()
        os._exit(0)

    signal.signal(signal.SIGTERM, on_term)
    importlib.import_module(module).main(list(argv))
    write()


# The recipe's step decay (a tenth at each third of the epochs) falls
# after 200 steps at this depth and stalls learning: 480 images for 60
# epochs with it reached anchor F1 0.20, 96 images for 30 epochs wrote no
# best-CSI model; a constant rate (--lr_step 1) reached 0.96 in 600 steps
# (NVIDIA H100 80GB HBM3, 700.00 W).
ACCURACY = {"train": 320, "valid": 16, "epochs": 60, "load_test_s": 5.0, "max_batch": 32,
            "clients": 32, "train_args": ["--lr_step", "1"]}


def phase_accuracy(card: str, tmp: Path) -> dict:
    """The accuracy chain (`tools.accuracy_run`) at a reduced depth, through
    the entry points a user calls: 320 train / 16 valid images rendered
    from the data seed (the first image's SHA-256 printed), `cli.train`
    under `tools.supervise` with the flagship recipe (resnet34, fpn_depth
    128, 512x512, bf16, focal, batch 32) for 60 epochs (600 steps) at a
    constant learning rate, the gate's four arms on its
    `model_best_csi.msgpack`, oracle arm D, a 5 s load test of
    `cli.serve` at max_batch 32 and the conf sweep. The train and
    serve subprocesses run under `_counted_module`, so the path's launch
    counts include theirs. Kernels A (validation, the checkpoint arm,
    oracle D, the sweep) and B (the server) must be launched; the
    checkpoint row's anchor F1 must be at least 0.5 and the float
    artifact's kps F1 within 0.01 of it. Returns the path's launch
    counts."""
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.tools import accuracy_run, load_test, supervise

    t_phase = time.perf_counter()
    counts_dir = tmp / "counts"
    wrap = [sys.executable, str(ROOT / "chip_smoke.py"), "--counts_out", str(counts_dir),
            "--module"]
    argv = ["--data", str(tmp / "data"), "--train", str(ACCURACY["train"]),
            "--valid", str(ACCURACY["valid"]), "--epochs", str(ACCURACY["epochs"]),
            "--out", str(tmp / "out"), "--labels", str(ROOT / "labels.json"),
            "--oracle_arms", "D", "--sweep", str(ACCURACY["max_batch"]),
            "--clients", str(ACCURACY["clients"]), "--duration", str(ACCURACY["load_test_s"]),
            "--", *ACCURACY["train_args"]]
    reset_launch_counts()
    with _patched(supervise, "TRAIN_COMMAND",
                  wrap + ["structuredetector_tpu_torch.cli.train", "--"]), \
            _patched(load_test, "SERVE_COMMAND",
                     wrap + ["structuredetector_tpu_torch.cli.serve", "--"]), _cwd(tmp):
        record = accuracy_run.run(accuracy_run.parse_args(argv))
    launches = launch_counts()
    by_process = {}
    for f in sorted(counts_dir.glob("*.json")):
        by_process[f.stem] = json.loads(f.read_text())
        for k, v in by_process[f.stem].items():
            launches[k] = launches.get(k, 0) + v
    gate = json.loads(Path(record["results"]["gate"]).read_text())
    rows = gate["summaries"]
    base, sdz = rows["checkpoint_bf16"], rows["sdz_float"]
    load = json.loads(Path(record["results"]["load_test"]).read_text())
    print(gate["table"], flush=True)
    result = {
        "phase": "accuracy", "card": card, "config": dict(ACCURACY),
        "model": "SDNet resnet34 fpn_depth=128 512x512 bf16, focal, batch 32, labels.json",
        "image_digest": record["image_digest"], "stages_s": record["stages_s"],
        "gate": gate["gate"], "table": gate["table"],
        "f1": {mode: {k: s.get(k) for k in ("anchor/f1_total", "kps/f1_total",
                                            "csi/f1_total", "classif/f1_total",
                                            "grouping/accuracy")}
               for mode, s in rows.items()},
        "sdz_float_kps_delta": sdz["kps/f1_total"] - base["kps/f1_total"],
        "oracle": record["oracle"], "load_test": load["runs"],
        "launches": launches, "launches_by_process": by_process,
        "seconds": time.perf_counter() - t_phase}
    emit(result)
    if not (launches.get("sigmoid_nms") and launches.get("sigmoid_nms_topk")):
        raise AssertionError(f"the accuracy path did not launch kernels A and B: {launches}")
    if base["anchor/f1_total"] < 0.5:
        raise AssertionError(f"checkpoint anchor F1 {base['anchor/f1_total']:.4f} < 0.5")
    if abs(result["sdz_float_kps_delta"]) > 0.01:
        raise AssertionError(f"sdz_float kps F1 departs from the checkpoint's by "
                             f"{result['sdz_float_kps_delta']:+.4f} (bar 0.01)")
    return launches


VARIANTS = {"resnet18": dict(backbone="resnet18"), "resnet50": dict(backbone="resnet50"),
            "resnet34_s2d": dict(s2d_stem=True), "resnet34_head_conv64": dict(head_conv=64)}


@contextlib.contextmanager
def _env(**values):
    """Environment variables set (None: unset) for the block, then restored."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _torchvision_resnet50(path: Path, seed: int) -> None:
    """A torchvision-layout resnet50 ImageNet state_dict (`conv1`, `bn1`,
    `layer1..4`, `fc`; no `num_batches_tracked`, as the published files
    have none) from a seeded port encoder: nothing is downloaded."""
    import torch

    from structuredetector_tpu_torch.models.network import SDNet, init_weights

    sd = {}
    for key, value in init_weights(SDNet(2, 1, backbone="resnet50"), seed).state_dict().items():
        head, _, rest = key.partition(".")
        if key.endswith("num_batches_tracked") or not head.startswith(("adpater", "down")):
            continue
        name = {"adpater.0": "conv1", "adpater.1": "bn1"}.get(key.rsplit(".", 1)[0])
        sd[f"{name}.{key.rsplit('.', 1)[1]}" if name else f"layer{head[4:]}.{rest}"] = value
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)


def phase_variants(card: str, tmp: Path):
    """The model variants at full width (512x512, fpn_depth 128, bf16,
    labels.json, seeded weights): resnet18, resnet50, resnet34 with the
    s2d stem and with `--head_conv 64`. For each: the batch-32 forward
    (CUDA events) and its peak memory, `predict_batch` img/s with kernel
    B's counter rising, the Decoder path (kernel A) identical to the
    serving decode from one forward, a batch-32 train step (ms, peak
    memory, finite loss, FLOPs' share of the bf16 peak, idle share), and
    a small fp32 model on the card against the CPU. Then once each:
    resnet50 through `cli.train --pretrained` (a torchvision-layout
    resnet50 in a temporary TORCH_HOME; kernel A in validation) and
    `cli.evaluate --backbone resnet50` on its checkpoint; a 7x7
    checkpoint in an s2d model; resnet50 int8 with static scales (every
    int8 conv shape exact against the CPU, the forward beside bf16 in
    turns); a `convert_export --head_conv 64` artifact under
    `ExportPredictor` against `Predictor`. Returns the launch counts of
    the run and the batch-32 forward ms of each variant."""
    import numpy as np
    import torch
    from PIL import Image

    from structuredetector_tpu_torch.cli import convert_export, evaluate, train
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.quantize import (
        calibrate_activation_scales,
        int8_convs,
        prequantize_variables,
    )
    from structuredetector_tpu_torch.models.weights import save_msgpack
    from structuredetector_tpu_torch.ops.device_augment import normalize_images
    from structuredetector_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from structuredetector_tpu_torch.predictor import ExportPredictor, Predictor, PreparedImage

    t_phase = time.perf_counter()
    labels = ROOT / "labels.json"
    base = Config(labels_path=labels).finalize()
    rng = np.random.default_rng(926354916)
    arrays = [rng.integers(0, 256, (base.height, base.width, 3), np.uint8) for _ in range(32)]
    feed = [PreparedImage(a, (base.width, base.height)) for a in arrays]
    small_arrays = [rng.integers(0, 256, (128, 128, 3), np.uint8) for _ in range(4)]
    result, forward_ms = {}, {}

    # --- the main path: counts set to 0 just before, read just after
    reset_launch_counts()
    for name, flags in VARIANTS.items():
        cfg = dataclasses.replace(base, **flags)
        pred = Predictor(cfg, device="cuda")
        batch = pred.to_device(arrays)
        with torch.inference_mode():
            pred.forward(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            fwd_ms = time_ms(lambda: pred.forward(batch), iters=10, warmup=2)
            peak = torch.cuda.max_memory_allocated() - resident
        before = launch_counts()
        img_s = _img_per_s(pred.predict_batch, feed)
        after = launch_counts()
        if after["sigmoid_nms_topk"] <= before["sigmoid_nms_topk"]:
            raise AssertionError(f"{name}: predict_batch did not launch kernel B")
        with torch.inference_mode():
            head = pred.forward(batch)
            dec_b, dec_a = pred.decode(head, fast_path=True), pred.decode(head, fast_path=False)
        for key in dec_b:
            if not torch.equal(dec_b[key], dec_a[key]):
                raise AssertionError(f"{name}: the Decoder path and kernel B differ on {key}")
        if launch_counts()["sigmoid_nms"] <= after["sigmoid_nms"]:
            raise AssertionError(f"{name}: the Decoder path did not launch kernel A")
        if not torch.isfinite(head).all():
            raise AssertionError(f"{name}: non-finite head output")
        objects = sum(len(a.objects) for a in pred.predict_batch(feed))
        del pred, batch, head
        torch.cuda.empty_cache()
        step = _time_train_steps(cfg, 32, warmup=3, iters=10)
        torch.cuda.empty_cache()
        small = Config(width=128, height=128, fpn_depth=32, use_amp=False,
                       labels_path=labels, **flags).finalize()
        gpu, cpu = Predictor(small, device="cuda"), Predictor(small, device="cpu")
        with torch.inference_mode():
            h_gpu = gpu.forward(gpu.to_device(small_arrays)).cpu()
            h_cpu = cpu.forward(cpu.to_device(small_arrays))
        card_vs_cpu = float((h_gpu - h_cpu).abs().max() / h_cpu.abs().max())
        if card_vs_cpu > 1e-4:
            raise AssertionError(f"{name}: card and CPU forwards differ by {card_vs_cpu:.2e}")
        forward_ms[name] = fwd_ms
        result[name] = {"forward_ms_batch32": fwd_ms, "forward_img_per_s": 32e3 / fwd_ms,
                        "forward_peak_bytes_above_resident": peak,
                        "predict_batch_img_per_s_batch32": img_s, "objects_in_batch32": objects,
                        "train_step_batch32": step,
                        "card_vs_cpu_fp32_128x128_max_rel": card_vs_cpu}

    # resnet50 through cli.train with --pretrained, then cli.evaluate
    _write_annotated(tmp / "train50", 32, seed=11)
    _write_annotated(tmp / "valid50", 8, seed=12)
    torch_home = tmp / "torch_home"
    _torchvision_resnet50(torch_home / "hub" / "checkpoints" / "resnet50-5eed0000.pth", seed=5)
    before = launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with _env(TORCH_HOME=str(torch_home), SDNET_PRETRAINED=None), _cwd(tmp), \
            contextlib.redirect_stdout(out):
        trainer = train.main(["--train_dir", str(tmp / "train50"), "--valid_dir",
                              str(tmp / "valid50"), "--labels", str(labels), "--backbone",
                              "resnet50", "--pretrained", "--epochs", "1",
                              "--eval_batch_size", "8", "--num_workers", "4"])
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if "Warm-started encoder from" not in out.getvalue():
        raise AssertionError("cli.train --pretrained did not warm-start the encoder")
    if launch_counts()["sigmoid_nms"] <= before["sigmoid_nms"]:
        raise AssertionError("cli.train validation did not launch kernel A")
    ckpt50 = tmp / trainer.save_dir / "model_best_loss.msgpack"
    steps50 = trainer.state.step
    del trainer
    common = ["--valid_dir", str(tmp / "valid50"), "--labels", str(labels), "--load_model",
              str(ckpt50), "--eval_batch_size", "8"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        evaluate.main(["--backbone", "resnet50", *common, "--save_summary",
                       str(tmp / "summary50.json")])
    evaluate_s = time.perf_counter() - t0
    summary = json.loads((tmp / "summary50.json").read_text())
    if not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"cli.evaluate --backbone resnet50: {summary}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate.main(common)
        raise AssertionError("a resnet50 checkpoint loaded into a resnet34 model")
    except ValueError as e:
        if "block kind" not in str(e):
            raise
    launches = launch_counts()
    # --- end of the main path

    # a 7x7 checkpoint in an s2d model: the stem rewritten exactly
    heads = {}
    for dtype_name, use_amp in (("bf16", True), ("fp32", False)):
        cfg = dataclasses.replace(base, use_amp=use_amp)
        std = Predictor(cfg, device="cuda")
        path = save_msgpack(std.model, tmp / "std.msgpack")
        s2d = Predictor(dataclasses.replace(cfg, s2d_stem=True, pretrained_model=path),
                        device="cuda")
        batch = std.to_device(arrays[:8])
        heads[dtype_name] = (std.forward(batch), s2d.forward(batch))
        if dtype_name == "fp32":
            dec = [p.decode(h, fast_path=True) for p, h in zip((std, s2d), heads["fp32"])]
        del std, s2d
    s2d_rel = {k: float((b - a).abs().max() / a.abs().max()) for k, (a, b) in heads.items()}
    for key in ("part_parent", "part_valid"):
        if not torch.equal(dec[0][key], dec[1][key]):
            raise AssertionError(f"s2d from a 7x7 checkpoint: fp32 detections differ on {key}")
    for key in ("anchors", "parts"):
        torch.testing.assert_close(dec[1][key], dec[0][key], rtol=0, atol=1e-3)
    # the bf16 bar of the serve phase; fp32 the card-against-CPU bar
    if s2d_rel["bf16"] > 0.08 or s2d_rel["fp32"] > 1e-4:
        raise AssertionError(f"s2d from a 7x7 checkpoint departs from the 7x7 model: {s2d_rel}")

    # resnet50 int8 with static scales against bf16, same weights
    cfg50 = dataclasses.replace(base, backbone="resnet50")
    bf16 = Predictor(cfg50, device="cuda")
    int8 = Predictor(dataclasses.replace(cfg50, int8=True), device="cuda")
    int8.model.load_state_dict(bf16.model.state_dict())
    if len(int8_convs(int8.model)) != 59:
        raise AssertionError("the int8 resnet50 must have 59 int8 convs")
    shapes = _int8_products_exact(int8, int8.to_device(arrays[:1]))
    cal = torch.from_numpy(np.stack(arrays[:16])).cuda()
    cal = normalize_images(cal.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    calibrate_activation_scales(int8.model, [cal])
    prequantize_variables(int8.model)
    batch = int8.to_device(arrays)
    with torch.inference_mode():
        int8_fwd = _in_turns({"bf16": lambda: bf16.forward(batch),
                              "int8": lambda: int8.forward(batch)},
                             lambda fn: time_ms(fn, iters=10, warmup=2))
        gap = _head_gap(int8.forward(batch), bf16.forward(batch))
    del bf16, int8, batch
    torch.cuda.empty_cache()

    # a --head_conv 64 artifact: ExportPredictor gives Predictor's annotations
    cfg_h = dataclasses.replace(base, head_conv=64)
    path = save_msgpack(Predictor(cfg_h, device="cuda").model, tmp / "head64.msgpack")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        artifact = convert_export.main([str(path), "-o", str(tmp / "head64.sdz"), "--params",
                                        str(labels), "--head_conv", "64", "--uint8_input",
                                        "--dynamic_batch"])
    convert_s = time.perf_counter() - t0
    pictures = [Image.fromarray(a) for a in arrays[:16]]
    live = Predictor(dataclasses.replace(cfg_h, pretrained_model=path), device="cuda")
    want = [a.json_repr() for a in live.predict_batch(pictures)]
    got = [a.json_repr() for a in ExportPredictor(artifact).predict_batch(pictures)]
    if got != want:
        raise AssertionError("ExportPredictor on the --head_conv 64 artifact and Predictor "
                             "disagree")

    emit({"phase": "variants", "card": card,
          "model": f"SDNet fpn_depth={base.fpn_depth} {base.width}x{base.height} bf16, labels "
                   f"{list(base.labels)} / {list(base.parts)}, seeded init",
          "timing": "forward: CUDA events, mean of 10 after 2 warm-up, uint8 feed on the card; "
                    "train step: CUDA events over 10 steps after 3, device augment; img/s: "
                    "host clock, 10 rounds of predict_batch on 32 PreparedImages",
          "variants": result,
          "cli_train_resnet50_pretrained": {"train_images": 32, "valid_images": 8, "epochs": 1,
                                            "steps": steps50, "wall_s": train_s,
                                            "evaluate_wall_s": evaluate_s,
                                            "evaluate_summary": {k: summary[k] for k in (
                                                "anchor/f1_total", "kps/f1_total")}},
          "s2d_from_7x7_checkpoint_head_max_rel": s2d_rel,
          "resnet50_int8_static": {"forward_ms_batch32": int8_fwd, "head_gap_vs_bf16": gap,
                                   "int8_product_exact_shapes": len(shapes)},
          "head_conv64_artifact": {"convert_export_s": convert_s, "images": len(pictures),
                                   "annotations_equal": True,
                                   "objects": sum(len(a["objects"]) for a in want)},
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    if gap > 0.25:  # JAX tests/test_int8.py:84's bar
        raise AssertionError(f"int8 resnet50 head departs from bf16 by {gap:.3f}")
    return launches, forward_ms


# a benchmark subprocess: the CLI's JSON line, then its process's launch counts
_BENCH = ("import json, sys\n"
          "from structuredetector_tpu_torch.cli import benchmark\n"
          "from structuredetector_tpu_torch.ops.kernels import launch_counts\n"
          "benchmark.main(sys.argv[1:])\n"
          "print(json.dumps({'launches': launch_counts()}), flush=True)\n")


def phase_benchmark(card: str, forward_ms: dict) -> dict:
    """`cli.benchmark --json` in a process of its own for resnet34 bf16,
    resnet50 bf16 and resnet34 `--int8_static`: its keys, finite values,
    kernel A launched (the process's own counts), and its `forward_fps`
    within 10 % of the batch-32 forward this run measured in the serve,
    variants and int8 phases (`forward_ms`, by run name). Returns the
    launch counts summed over the processes."""
    import subprocess

    runs = {"resnet34 bf16": [], "resnet50 bf16": ["--backbone", "resnet50"],
            "resnet34 int8_static": ["--int8_static"]}
    keys = {"forward_fps", "e2e_plain_fps", "e2e_kernel_fps", "e2e_latency_batch1_ms",
            "decode_plain_us_per_img", "decode_kernel_us_per_img", "train_step_imgs_per_s"}
    out, total = {}, {}
    for name, flags in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _BENCH, "--json", *flags], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"cli.benchmark {name}: exit {proc.returncode}\n"
                                 f"{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        result, launches = json.loads(lines[-2]), json.loads(lines[-1])["launches"]
        want = keys - ({"train_step_imgs_per_s"} if "--int8_static" in flags else set())
        if set(result) != want or not all(math.isfinite(v) and v > 0 for v in result.values()):
            raise AssertionError(f"cli.benchmark {name}: {result}")
        if not launches["sigmoid_nms"]:
            raise AssertionError(f"cli.benchmark {name} did not launch kernel A: {launches}")
        ms = 32e3 / result["forward_fps"]
        rel = ms / forward_ms[name] - 1.0
        out[name] = {"result": result, "launches": launches, "wall_s": time.perf_counter() - t0,
                     "forward_ms": ms, "in_call_forward_ms": forward_ms[name],
                     "forward_rel_diff": rel}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "benchmark", "run": name, "flags": flags, **out[name]})
    emit({"phase": "benchmark", "card": card, "runs": list(runs),
          "compared_with": "forward_ms_batch32 of the serve phase (resnet34 bf16), the variants "
                           "phase (resnet50 bf16) and the int8 phase (int8 static, "
                           "prequantized)", "launches": total})
    bad = {k: v["forward_rel_diff"] for k, v in out.items() if abs(v["forward_rel_diff"]) > 0.10}
    if bad:
        raise AssertionError(f"cli.benchmark's forward departs from the in-call forward: {bad}")
    return total


def emit_kernel_table(kernels: dict, by_path: dict) -> None:
    """The `{"kernels": [...]}` line: each kernel's source, the TPU kernel
    it replaces (None: no TPU counterpart), its launches by main path and
    the kernels phase's measurements."""
    sources = {
        "sigmoid_nms": ("structuredetector_tpu_torch/csrc/sigmoid_nms.cu",
                        "structuredetector_tpu/ops/pallas/nms.py:35"),
        "sigmoid_nms_topk": ("structuredetector_tpu_torch/csrc/sigmoid_nms_topk.cu",
                             "structuredetector_tpu/ops/pallas/topk.py:62"),
        "sigmoid_nms_topk_rowmax": ("structuredetector_tpu_torch/csrc/sigmoid_nms_topk_rowmax.cu",
                                    "structuredetector_tpu/ops/pallas/topk.py:116"),
        "swin_window_attention": ("structuredetector_tpu_torch/csrc/swin_window_attention.cu",
                                  None),
    }
    extra = ("topk_partial_ms", "ms_by_k_64_planes", "ms_runs", "phases_ms",
             "copy_same_bytes_ms", "saturated_ms", "saturated_ms_runs", "saturated_bound_share",
             "us_per_round", "active_clusters", "blocks", "block_counts", "clocks", "timed_work")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": sum(counts.get(name, 0) for counts in by_path.values()),
         "launches_by_path": {path: counts.get(name, 0) for path, counts in by_path.items()},
         **{k: v for k, v in kernels[name].items() if k not in extra}}
        for name, (src, replaces) in sources.items()
    ]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--load_model", type=Path, default=None,
                   help="a .pth or .msgpack to run instead of the seeded init")
    p.add_argument("--parent", type=Path, default=None,
                   help="another checkout (the parent commit): also time its kernels A, "
                        "B and C, through its public wrappers, against this one's, in turns")
    # the data_parallel phase's own processes: a rank of its step, a rank
    # of cli.train under torchrun (its arguments after --)
    p.add_argument("--dp_rank_out", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp_cli_out", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--ma_case", default=None, help=argparse.SUPPRESS)
    # the accuracy phase's train and serve subprocesses: a module's main
    # (its arguments after --) with its launch counts written into a directory
    p.add_argument("--counts_out", type=Path, default=None, help=argparse.SUPPRESS)
    p.add_argument("--module", default=None, help=argparse.SUPPRESS)
    p.add_argument("cli_argv", nargs="*", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "structuredetector_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.dp_rank_out is not None:
        if args.ma_case:
            _ma_rank(args.dp_rank_out, args.ma_case)
        else:
            _dp_rank(args.dp_rank_out)
        return 0
    if args.dp_cli_out is not None:
        _dp_cli_rank(args.dp_cli_out, args.cli_argv)
        return 0
    if args.counts_out is not None:
        _counted_module(args.counts_out, args.module, args.cli_argv)
        return 0
    from structuredetector_tpu_torch.tools.timing import card as query_card

    t_start = time.perf_counter()
    card = query_card()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    library = phase_build()
    kernels, swin_counts = phase_kernels(card)
    if args.parent is not None:
        phase_parent(card, args.parent.resolve())
    forward_ms = {}
    by_path = {}
    by_path["serve"], forward_ms["resnet34 bf16"] = phase_serve(card, args.load_model)
    by_path["topk_variants"] = phase_topk_variants(card)
    with tempfile.TemporaryDirectory(prefix="sdnet-smoke-") as work:
        work = Path(work)
        by_path["evaluate_detect"], ckpt, gt_dir = phase_evaluate_detect(
            card, args.load_model, work)
        by_path["native_io"] = phase_native_io(card, library, work, ckpt, gt_dir)
        by_path["export"] = phase_export(card, work, ckpt, gt_dir)
        by_path["int8"], forward_ms["resnet34 int8_static"] = phase_int8(card, work, ckpt,
                                                                         gt_dir)
    phase_reference(card)
    by_path["train"] = phase_train(card)
    by_path["data_parallel"] = phase_data_parallel(card)
    by_path["model_axis"] = phase_model_axis(card)
    by_path["library"] = phase_library(card)
    with tempfile.TemporaryDirectory(prefix="sdnet-accuracy-") as work:
        by_path["accuracy"] = phase_accuracy(card, Path(work))
    with tempfile.TemporaryDirectory(prefix="sdnet-variants-") as work:
        by_path["variants"], variant_ms = phase_variants(card, Path(work))
    forward_ms["resnet50 bf16"] = variant_ms["resnet50"]
    by_path["benchmark"] = phase_benchmark(card, forward_ms)

    by_path["swin_forward"] = swin_counts
    emit_kernel_table(kernels, by_path)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
