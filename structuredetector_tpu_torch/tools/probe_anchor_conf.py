"""Probe anchor-channel confidence at the ground-truth stem locations.

    python -m structuredetector_tpu_torch.tools.probe_anchor_conf CKPT \\
        --valid_dir D [--labels labels.json] [--anchor_name stem] \\
        [-W 512 -H 512] [--out probe.json] [--device cpu]

The port of the JAX repo's `tools/probe_anchor_conf.py`. For every GT
object of a set it records, in a 3x3 grid window around the GT stem,

- the sigmoid confidence of the object's own species channel,
- the best other species channel (confidence split between species),
- the channel sum (what a species-agnostic detector would see),

and prints per-species quantiles and the share clearing 0.2 / 0.3 /
0.4: the evidence for choosing `--conf_threshold` on a set (the
reference exposes the same knob). The forward is the `Predictor`'s on
the host-normalized feed, bf16 autocast, on `--device`.
`localize_image_names` rewrites the set's JSONs, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--valid_dir", type=Path, required=True)
    p.add_argument("--labels", type=Path, default=Path("labels.json"))
    p.add_argument("--anchor_name", type=str, default="stem")
    p.add_argument("--width", "-W", type=int, default=512)
    p.add_argument("--height", "-H", type=int, default=512)
    p.add_argument("--fpn_depth", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the model runs on ('cuda' or 'cpu').")
    args = p.parse_args(argv)

    import torch

    from ..config import Config
    from ..data import CropDataset, Loader, ValidationAugmentation
    from ..predictor import Predictor

    cfg = Config(width=args.width, height=args.height,
                 fpn_depth=args.fpn_depth, valid_dir=args.valid_dir,
                 anchor_name=args.anchor_name, use_amp=True,
                 labels_path=args.labels)
    cfg.load_labels()
    cfg.validate()

    predictor = Predictor(cfg, model_path=args.checkpoint, device=args.device,
                          device_normalize=False)
    dataset = CropDataset(cfg, args.valid_dir, ValidationAugmentation(cfg))
    dataset.localize_image_names()
    loader = Loader(dataset, batch_size=args.batch_size)

    out_w, out_h = cfg.grid_size()
    sx, sy = out_w / cfg.width, out_h / cfg.height

    # per species: list of (own, best_other, total) window-max confidences
    recs = {name: [] for name in cfg.labels}
    for batch in loader:
        head = predictor.forward(predictor.to_device(batch["image"]))
        hm = torch.sigmoid(head[:, :cfg.n_labels].float()).permute(0, 2, 3, 1).cpu().numpy()
        for i, annotation in enumerate(batch["annotation"]):
            for obj in annotation.objects:
                gx = int(round(obj.x * sx))
                gy = int(round(obj.y * sy))
                y0, y1 = max(0, gy - 1), min(out_h, gy + 2)
                x0, x1 = max(0, gx - 1), min(out_w, gx + 2)
                win = hm[i, y0:y1, x0:x1, :]  # (wy, wx, n_labels)
                per_ch = win.reshape(-1, win.shape[-1]).max(axis=0)
                ci = cfg.labels[obj.name]
                own = float(per_ch[ci])
                other = float(np.delete(per_ch, ci).max()) if len(per_ch) > 1 else 0.0
                recs[obj.name].append((own, other, float(per_ch.sum())))

    report = {}
    for name, rows in recs.items():
        if not rows:
            continue
        arr = np.asarray(rows)  # (n, 3)
        own, other, total = arr[:, 0], arr[:, 1], arr[:, 2]
        report[name] = {
            "n": len(rows),
            "own_q25_50_75": [round(float(q), 3) for q in
                              np.percentile(own, [25, 50, 75])],
            "best_other_median": round(float(np.median(other)), 3),
            "sum_median": round(float(np.median(total)), 3),
            **{f"own_ge_{t}": round(float((own >= t).mean()), 3)
               for t in (0.2, 0.3, 0.4)},
            **{f"sum_ge_{t}": round(float((total >= t).mean()), 3)
               for t in (0.2, 0.3, 0.4)},
        }
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
