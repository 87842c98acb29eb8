"""Device throughput of the port: forward, end to end, decode and the train step.

    python -m structuredetector_tpu_torch.cli.benchmark [-W 512 -H 512 -b 32]
        [--backbone resnet18|resnet34|resnet50] [--fpn_depth 128] [--iters 20]
        [--fp32 | --int8 | --int8_static] [--json] [--device cuda|cpu]

The port of `structuredetector_tpu/cli/benchmark.py`, with its flags
plus `--device` (default `cuda`). Seeded weights, zero images, labels
bean, maize / leaf. Sections and their keys (the JAX key in brackets
where it differs):

- `forward_fps`: the forward alone;
- `e2e_plain_fps` [`e2e_xla_fps`]: forward + `decode_feature_maps` with
  the plain sigmoid + NMS front;
- `e2e_kernel_fps` [`e2e_pallas_fps`]: the same with kernel A
  (`ops.kernels.sigmoid_nms`) as the front, passed as `nms_fn` as JAX
  passes its Pallas kernel;
- `e2e_latency_batch1_ms`: forward + decode of one image (kernel A on
  the card);
- `decode_plain_us_per_img` / `decode_kernel_us_per_img`
  [`decode_xla_us_per_img` / `decode_pallas_us_per_img`]: the decode
  alone on zero maps;
- `train_step_imgs_per_s`: the train step (loss, backward, Adam), its
  state carried from step to step, every keypoint slot filled; skipped
  under `--int8`, which is inference-only.

On the card every time is device time from CUDA events over `--iters`
calls (`tools.timing.device_ms`: the launches queue behind a sleep
kernel, the counterpart of JAX's chained `lax.scan`, so the port needs
none of the longer chains JAX takes to drown its dispatch), and the
kernel sections run kernel A or raise. With `--device cpu` the times are the host's
clock and the kernel sections are left out, as JAX leaves its Pallas
sections out off the TPU. `--int8_static` calibrates the activation
scales on uniform values in [-2.12, 2.64] (the ImageNet-normalized
input range) from a `torch.Generator` seeded 0, then prequantizes the
weights, as JAX does.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", "-W", type=int, default=512)
    p.add_argument("--height", "-H", type=int, default=512)
    p.add_argument("--batch_size", "-b", type=int, default=32)
    p.add_argument("--fpn_depth", type=int, default=128,
                   help="FPN width to benchmark (compare model sizes).")
    p.add_argument("--backbone", type=str, default="resnet34",
                   choices=("resnet18", "resnet34", "resnet50"))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="Int8 inference convs (models/quantize.py); skips "
                        "the train-step section (int8 is inference-only).")
    p.add_argument("--int8_static", action="store_true",
                   help="Int8 with static activation scales (calibrated on "
                        "uniform values in the normalized input range) — no "
                        "per-call amax pass; implies --int8.")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (device time, kernel A) or 'cpu' (host clock, "
                        "no kernel sections).")
    args = p.parse_args(argv)
    args.int8 = args.int8 or args.int8_static
    return args


def _timer(device, iters: int):
    """ms a call of `fn()`: device time on the card, host clock on the CPU."""
    if device.type == "cuda":
        from ..tools.timing import device_ms

        return lambda fn, n=iters: device_ms(fn, iters=n, warmup=min(3, n))

    def host_ms(fn, n=iters):
        fn()  # warm-up
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    return host_ms


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from ..config import Config
    from ..models.network import init_model
    from ..ops.decode import decode_feature_maps
    from ..ops.kernels import launch_counts, sigmoid_nms
    from ..train.state import create_train_state
    from ..train.steps import train_step
    from ..utils import resolve_device

    device = resolve_device(args.device)
    cfg = Config(width=args.width, height=args.height, use_amp=not args.fp32,
                 int8=args.int8, fpn_depth=args.fpn_depth, backbone=args.backbone)
    cfg.set_labels(["bean", "maize"], ["leaf"])
    cfg.validate()
    b = args.batch_size
    timed = _timer(device, args.iters)
    on_card = device.type == "cuda"

    model = init_model(cfg).to(device)
    if args.int8:
        from ..models.quantize import calibrate_activation_scales, prequantize_variables

        if args.int8_static:
            # random data spanning the normalized input range: an all-zeros
            # batch would drive every act_scale to the 1/127 fallback
            g = torch.Generator().manual_seed(0)
            warm = torch.rand((b, 3, cfg.height, cfg.width), generator=g) * 4.76 - 2.12
            calibrate_activation_scales(model, [warm.to(device)])
        prequantize_variables(model)
    images = torch.zeros((b, 3, cfg.height, cfg.width), device=device)
    results = {}

    def infer(x, nms_fn):
        return decode_feature_maps(
            model(x), max_objects=cfg.max_objects, max_parts=cfg.max_parts,
            conf_thresh=cfg.conf_threshold, dist_thresh=cfg.decoder_dist_thresh,
            nms_fn=nms_fn)

    fronts = {"plain": None, **({"kernel": sigmoid_nms} if on_card else {})}
    before = launch_counts()["sigmoid_nms"]
    with torch.inference_mode():
        results["forward_fps"] = b / timed(lambda: model(images)) * 1e3
        for name, nms_fn in fronts.items():
            results[f"e2e_{name}_fps"] = b / timed(lambda f=nms_fn: infer(images, f)) * 1e3
        one = images[:1]
        results["e2e_latency_batch1_ms"] = timed(lambda: infer(one, fronts.get("kernel")))

        out_h, out_w = cfg.height // 4, cfg.width // 4
        maps = {"anchor_hm": torch.zeros((b, cfg.n_labels, out_h, out_w), device=device),
                "part_hm": torch.zeros((b, cfg.n_parts, out_h, out_w), device=device),
                "offsets": torch.zeros((b, 2, out_h, out_w), device=device),
                "embeddings": torch.zeros((b, 2, out_h, out_w), device=device)}
        for name, nms_fn in fronts.items():
            ms = timed(lambda f=nms_fn: decode_feature_maps(
                maps, max_objects=cfg.max_objects, max_parts=cfg.max_parts,
                conf_thresh=cfg.conf_threshold, dist_thresh=cfg.decoder_dist_thresh,
                nms_fn=f))
            results[f"decode_{name}_us_per_img"] = ms / b * 1e3
    if on_card and launch_counts()["sigmoid_nms"] == before:
        raise RuntimeError("the kernel sections did not launch kernel A (sigmoid_nms)")

    if not args.int8:  # int8 is inference-only (the model refuses train mode)
        state = create_train_state(cfg, model, steps_per_epoch=100)
        o, p = cfg.max_objects, cfg.max_parts
        kp = {"anchors_xy": torch.ones((b, o, 2)), "anchor_cls": torch.zeros((b, o), dtype=torch.int32),
              "anchor_mask": torch.ones((b, o), dtype=torch.bool),
              "parts_xy": torch.ones((b, p, 2)), "part_kind": torch.zeros((b, p), dtype=torch.int32),
              "part_owner_xy": torch.ones((b, p, 2)), "part_mask": torch.ones((b, p), dtype=torch.bool)}
        kp = {k: v.to(device) for k, v in kp.items()}
        nhwc = torch.zeros((b, cfg.height, cfg.width, 3), device=device)
        ms = timed(lambda: train_step(state, nhwc, kp, cfg))
        results["train_step_imgs_per_s"] = b / ms * 1e3

    _report(results, args, device)
    return results


def _report(results: dict, args, device) -> None:
    if args.as_json:
        print(json.dumps({k: round(v, 2) for k, v in results.items()}), flush=True)
        return
    import torch

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    dtype = "fp32" if args.fp32 else ("int8" if args.int8 else "bf16")
    print(f"device={name} batch={args.batch_size} {args.width}x{args.height} "
          f"backbone={args.backbone} dtype={dtype}")
    for k, v in results.items():
        print(f"  {k:28s} {v:12.2f}")


if __name__ == "__main__":
    main()
