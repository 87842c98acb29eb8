"""HTTP inference server with micro-batching, on the port.

    python -m structuredetector_tpu_torch.cli.serve --load_model model.pth [config flags]

POST an image to /detect, get the annotation JSON back (reference
schema, original pixel coordinates). Concurrent requests group into
device batches (serve.MicroBatcher).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serve a trained model over HTTP with micro-batching."
    )
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to serve on ('cuda' or 'cpu').")
    p.add_argument("--max_batch", type=str, default="auto",
                   help="Device batch cap; batches pad to powers of two. "
                        "'auto' (default, CUDA only) times one warm batch-32 "
                        "forward and the host->device copy rate at startup "
                        "and picks 128 when copying an extra image is cheaper "
                        "than computing it, else 32. Pass an integer to pin it.")
    p.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="How long to wait for more requests after the "
                        "first of a batch arrives.")
    p.add_argument("--submit_timeout_s", type=float, default=30.0,
                   help="Per-request cap on time waiting for the device "
                        "(503 on expiry).")
    p.add_argument("--pipeline", action="store_true",
                   help="Depth-2 serving pipeline: host prep and copy of "
                        "batch N+1 overlap device work of batch N. Declined "
                        "at startup where the measured copy rate is too low "
                        "for it to pay.")
    p.add_argument("--pipeline_force", action="store_true",
                   help="Run the depth-2 pipeline without the startup check "
                        "(implies --pipeline).")
    p.add_argument("--no_warmup", action="store_true",
                   help="Skip running each power-of-two batch shape once at "
                        "startup.")
    args, rest = p.parse_known_args(argv)

    from ..config import config_from_args
    from ..predictor import Predictor
    from ..serve import (
        measure_device_ms_per_img,
        probe_h2d_mbps,
        resolve_auto_max_batch,
        resolve_pipeline,
        run_server,
    )

    config = config_from_args(rest)
    if not config.pretrained_model:
        raise SystemExit("No model to serve. Use '--load_model <model.pth>'.")
    predictor = Predictor(config, device=args.device)

    measured = None  # (h2d MB/s, device ms/img), taken once
    if args.max_batch == "auto" or (args.pipeline and not args.pipeline_force):
        if predictor.device.type != "cuda":
            raise SystemExit("--max_batch auto and --pipeline measure the card; "
                             "pass an integer --max_batch on the CPU")
        measured = (probe_h2d_mbps(predictor.device),
                    measure_device_ms_per_img(predictor))
        print(f"measured: H2D {measured[0]:.0f} MB/s, device "
              f"{measured[1]:.3f} ms/img at batch 32")
    if args.max_batch == "auto":
        args.max_batch = resolve_auto_max_batch(*measured)
        print(f"max_batch auto -> {args.max_batch}")
    else:
        args.max_batch = int(args.max_batch)

    if args.pipeline_force:
        args.pipeline = True
    elif args.pipeline and not resolve_pipeline(*measured):
        print("pipeline: declined — copying an image takes longer than "
              "computing it on this card; running sync. --pipeline_force "
              "overrides.")
        args.pipeline = False

    if not args.no_warmup:
        # run every batch shape the micro-batcher can produce once now
        # (cuDNN picks its algorithms per shape), not on a live request
        from PIL import Image

        dummy = Image.new("RGB", (config.width, config.height))
        sizes, b = [], 1
        while b < args.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(args.max_batch)  # _pad_pow2 caps here
        for b in sizes:
            print(f"warmup: batch {b}")
            predictor.predict_batch([dummy] * b)

    print(f"serving on http://{args.host}:{args.port} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms} ms, "
          f"device={predictor.device}) POST /detect, GET /healthz")
    run_server(predictor, args.host, args.port,
               max_batch=args.max_batch, window_ms=args.batch_window_ms,
               submit_timeout_s=args.submit_timeout_s,
               pipeline=args.pipeline)


if __name__ == "__main__":
    main()
