"""Serialize a trained model into a portable inference artifact, on the port.

    python -m structuredetector_tpu_torch.cli.convert_export model.msgpack|model.pth \\
        [-o model.sdz] [--norm] [--uint8_input] [--dynamic_batch] [--int8 \\
        [--calibrate_dir DIR]] [--device cpu]

The port of `structuredetector_tpu/cli/convert_export.py`, with its
flags, plus `--device` (default `cuda`): the program is traced for that
device and runs only there (`export.py`). The compute dtype is the
config default, bf16 autocast, as in the JAX command.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", type=str, help="Path to the trained model to convert "
                                           "(a JAX .msgpack or a reference-layout .pth).")
    p.add_argument("--output", "-o", type=str, default="model.sdz",
                   help="Output file name of the exported model.")
    p.add_argument("--width", "-W", default=512, type=int)
    p.add_argument("--height", "-H", default=512, type=int)
    p.add_argument("--params", "-p", type=str, default="labels.json",
                   help="Json file of anchor and part names.")
    p.add_argument("--scale-factor", "-s", type=int, default=4)
    p.add_argument("--fpn-depth", type=int, default=128)
    p.add_argument("--head_conv", type=int, default=0,
                   help="Hidden head width the checkpoint was trained with: 0 (the "
                        "single 1x1 head) only in the port.")
    p.add_argument("--anchor_name", type=str, default="anchor")
    p.add_argument("--batch_size", "-b", type=int, default=1,
                   help="Static batch size baked into the artifact.")
    p.add_argument("--dynamic_batch", action="store_true",
                   help="Export with a symbolic batch dimension (one artifact "
                        "serves any batch size).")
    p.add_argument("--norm", action="store_true",
                   help="Fold ImageNet normalization into the graph: the exported "
                        "model consumes raw [0,255] RGB.")
    p.add_argument("--uint8_input", action="store_true",
                   help="Bake a uint8 RGB input signature (implies --norm): a "
                        "quarter of float32's feed bytes.")
    p.add_argument("--int8", action="store_true",
                   help="Bake int8 inference convs into the graph (prequantized "
                        "per-channel weights, dynamic per-sample activations).")
    p.add_argument("--calibrate_dir", type=str, default=None,
                   help="With --int8: directory of representative images; bakes "
                        "static activation scales (no per-call amax pass).")
    p.add_argument("--calibrate_images", type=int, default=16,
                   help="Max images sampled from --calibrate_dir.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the program is traced for and runs on ('cuda' or 'cpu').")
    return p.parse_args(argv)


def _calibrated(config, weights, cal_dir: Path, max_images: int, device):
    """Static int8 activation scales from representative images: resized
    and normalized on the host as the `evaluate` feed is, then every int8
    conv records its input amax (`models.quantize`). Returns the
    calibrated state_dict."""
    import numpy as np
    import torch

    from ..data.augment import PredictionTransformation
    from ..data.dataset import PredictionDataset
    from ..models.network import build_model
    from ..models.quantize import calibrate_activation_scales

    dataset = PredictionDataset(cal_dir)
    n = min(len(dataset), max_images)
    if n <= 0:
        raise SystemExit(
            f"--calibrate_dir {cal_dir}: no calibration images "
            f"({len(dataset)} .jpg/.jpeg/.png found, --calibrate_images {max_images})"
        )
    transform = PredictionTransformation(config, device_normalize=False)
    batch = np.stack([transform(dataset[i]["img"]) for i in range(n)])
    model = build_model(config)
    model.load_state_dict(weights, strict=True)
    model = model.eval().to(device)
    x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2).contiguous()
    return calibrate_activation_scales(model, [x]).state_dict()


def main(argv=None):
    args = parse_args(argv)

    from ..config import Config
    from ..export import export_model
    from ..models.network import build_model
    from ..models.weights import check_architecture, load_checkpoint
    from ..utils import resolve_device

    names = json.loads(Path(args.params).expanduser().resolve().read_text())
    if not isinstance(names["labels"], list) or not isinstance(names["parts"], list):
        raise ValueError("labels/parts in the params file should be lists")
    config = Config(
        width=args.width, height=args.height, fpn_depth=args.fpn_depth,
        down_ratio=float(args.scale_factor), anchor_name=args.anchor_name,
        int8=args.int8, head_conv=max(0, args.head_conv),
    ).set_labels(names["labels"], names["parts"])
    config.validate()
    device = resolve_device(args.device)

    path = Path(args.model).expanduser().resolve()
    weights = load_checkpoint(path)
    check_architecture(build_model(config), weights, source=str(path))
    if args.calibrate_dir:
        if not args.int8:
            raise SystemExit("--calibrate_dir requires --int8")
        weights = _calibrated(config, weights,
                              Path(args.calibrate_dir).expanduser().resolve(),
                              args.calibrate_images, device)
    out = export_model(config, weights, args.output, batch_size=args.batch_size,
                       fold_normalization=args.norm or args.uint8_input,
                       dynamic_batch=args.dynamic_batch, uint8_input=args.uint8_input,
                       device=device)
    print(f"Exported to {out}")
    return out


if __name__ == "__main__":
    main()
