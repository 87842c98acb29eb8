#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`structuredetector_tpu_torch`).

    python3 chip_smoke.py [--load_model model.pth]

Runs on one NVIDIA GPU from the root of a checkout and imports nothing
of JAX or of the JAX package. Phases, one JSON line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles every kernel of the serving path from csrc/ (nvcc,
   sm_90a, one process per source, in parallel);
3. kernels: holds each kernel bit-exact against its plain PyTorch
   version at the serving shapes and on edge cases, and times kernel,
   plain version and yardstick with CUDA events;
4. serve (the main path): a full-width SDNet (resnet34, fpn_depth 128,
   512x512, bf16, labels.json) behind the port's micro-batching HTTP
   server answers concurrent PNG POSTs; the Decoder path (kernel A) and
   the serving decode (kernel B) must give identical detections from one
   forward, the kernel-fronted decode must equal the plain-fronted one,
   and both kernels' launch counters must rise. Then it times batch-32
   throughput and reports the request latency;
5. reference: a small fp32 model on the card agrees with the same model
   on the CPU.

Then the `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without CUDA, or without the package beside this file, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import subprocess
import sys
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of `fn()` over `iters` calls, CUDA events.

    The stream first runs a ~50 ms sleep kernel, so all `iters` calls are
    queued before the start event runs: the time is the device's, free of
    the host's launch overhead (the work here is host-bound otherwise)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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

    rng = np.random.default_rng(926354916)

    def logits(*shape):
        return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()

    # kernel A: (32, 3, 128, 128), the two serving shapes, a non-square plane
    err_a = 0.0
    for shape in ((32, 3, 128, 128), (32, 2, 128, 128), (32, 1, 128, 128), (3, 2, 40, 72)):
        x = logits(*shape)
        got, want = sigmoid_nms(x), sigmoid_nms_reference(x)
        err_a = max(err_a, max_abs_diff(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"sigmoid_nms differs from its plain version at {shape}")

    # kernel B: serving shapes (anchors 2 x 32, parts 32), a plane count
    # not a multiple of 8, an all-equal plane, non-square planes, and a
    # 256x256 plane (global-scratch path)
    cases = [(logits(64, 128, 128), 20), (logits(32, 128, 128), 40),
             (logits(100, 128, 128), 20), (torch.zeros((2, 128, 128), device="cuda"), 40),
             (logits(3, 40, 72), 9), (logits(4, 256, 256), 40)]
    err_b = 0.0
    for planes, k in cases:
        got, want = sigmoid_nms_topk(planes, k), sigmoid_nms_topk_reference(planes, k)
        for g, w in zip(got, want):
            err_b = max(err_b, max_abs_diff(g, w))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"sigmoid_nms_topk differs from its plain version at "
                    f"{tuple(planes.shape)}, k={k}")
    flat_inds = sigmoid_nms_topk(cases[3][0], 40)[1]
    if flat_inds.cpu().tolist() != [list(range(40))] * 2:
        raise AssertionError("all-equal plane: ties must go to ascending flat index")

    # timings at the main path's per-batch work (batch 32, 128x128 grid):
    # kernel A runs on anchors (32, 2) and parts (32, 1); kernel B on the
    # 64 anchor planes (k=20) and the 32 part planes (k=40)
    anchors, parts = logits(32, 2, 128, 128), logits(32, 1, 128, 128)
    a_planes, p_planes = anchors.reshape(64, 128, 128), parts.reshape(32, 128, 128)
    pixels = anchors.numel() + parts.numel()

    a_ms = time_ms(lambda: (sigmoid_nms(anchors), sigmoid_nms(parts)))
    a_plain = time_ms(lambda: (sigmoid_nms_reference(anchors), sigmoid_nms_reference(parts)))
    a_bound, a_by = bound_ms(2 * 4 * pixels, FRONT_OPS_PER_PIXEL * pixels)

    b_ms = time_ms(lambda: (sigmoid_nms_topk(a_planes, 20), sigmoid_nms_topk(p_planes, 40)))
    b_plain = time_ms(lambda: (sigmoid_nms_topk_reference(a_planes, 20),
                               sigmoid_nms_topk_reference(p_planes, 40)))
    out_bytes = (64 * 20 + 32 * 40) * 8
    b_bound, b_by = bound_ms(4 * pixels + out_bytes,
                             (FRONT_OPS_PER_PIXEL + SELECT_OPS_PER_PIXEL) * pixels)
    # kernel B against k on the anchor planes: t(k) ~ t0 + k * (a round)
    b_by_k = {k: time_ms(lambda k=k: sigmoid_nms_topk(a_planes, k)) for k in (1, 20, 40)}
    # partial yardstick: torch.topk over the already suppressed planes
    # (selection only; no single PyTorch call computes the whole function)
    sup_a = sigmoid_nms_reference(a_planes).reshape(64, -1)
    sup_p = sigmoid_nms_reference(p_planes).reshape(32, -1)
    topk_partial = time_ms(lambda: (torch.topk(sup_a, 20), torch.topk(sup_p, 40)))

    result = {
        "sigmoid_nms": {"max_abs_err": err_a, "ms": a_ms, "plain_ms": a_plain,
                        "bound_ms": a_bound, "bound_by": a_by, "library_ms": None},
        "sigmoid_nms_topk": {"max_abs_err": err_b, "ms": b_ms, "plain_ms": b_plain,
                             "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
                             "topk_partial_ms": topk_partial,
                             "ms_by_k_64_planes": b_by_k},
    }
    emit({"phase": "kernels", "card": card, "bit_exact": True,
          "timed_work": "one served batch of 32 at 512x512: anchors (32,2,128,128) + "
                        "parts (32,1,128,128); warm L2, CUDA events, mean of 50",
          "topk_partial_ms_is": "torch.topk over the suppressed planes only (partial)",
          **{k: v for k, v in result.items()}})
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
    from structuredetector_tpu_torch.ops.kernels import sigmoid_nms, sigmoid_nms_topk
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
    sigmoid_nms.launches = 0
    sigmoid_nms_topk.launches = 0
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
    launches = {"sigmoid_nms": sigmoid_nms.launches,
                "sigmoid_nms_topk": sigmoid_nms_topk.launches}
    if min(launches.values()) == 0:
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
    # bf16 keeps 8 bits of mantissa through 40 layers: 0.039 measured on
    # an H100 with the seeded weights; the bar is twice that
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--load_model", type=Path, default=None,
                   help="reference-layout .pth to serve instead of the seeded init")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "structuredetector_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    phase_build()
    kernels = phase_kernels(card)
    launches = phase_serve(card, args.load_model)
    phase_reference(card)

    sources = {"sigmoid_nms": ("structuredetector_tpu_torch/csrc/sigmoid_nms.cu",
                               "structuredetector_tpu/ops/pallas/nms.py:35"),
               "sigmoid_nms_topk": ("structuredetector_tpu_torch/csrc/sigmoid_nms_topk.cu",
                                    "structuredetector_tpu/ops/pallas/topk.py:62")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **{k: v for k, v in kernels[name].items()
                                        if k not in ("topk_partial_ms", "ms_by_k_64_planes")}}
        for name, (src, replaces) in sources.items()
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
