"""Oracle ablations of the structural grouping (CSI) chain.

    python -m structuredetector_tpu_torch.tools.oracle_grouping --valid_dir D \\
        --load_model trainings/<ts>/model_best_csi.msgpack [--arms ABCD] \\
        [--limit N] [--out oracle.json] [--device cpu] [config flags]

The port of the JAX repo's `tools/oracle_grouping.py`. It finds which
stage of the chain loses structure by substituting ground truth at
successive points:

  A. pred = GT (scored) -> Evaluator           — tests the evaluator
  B. GT -> flatten -> encode -> dense maps -> Decoder -> Evaluator
                                               — tests encode + decode
  C. model forward, then per-head GT substitution:
       C1: predicted heatmaps + offsets, GT embedding map
       C2: GT heatmaps + offsets, predicted embedding map
                                               — isolates the failing head
  D. plain model eval (control, should match the gate's numbers)

plus a direct part -> parent accuracy (grouping rate): the share of
decoded parts matched to a GT part whose assigned parent anchor lies
within the evaluation distance of that part's true owner.

The dense maps come from the port's `ops.encode.encode_targets`; every
decode goes through the port's `Decoder` on `--device`, whose front is
kernel A on the card. The model runs as `cli.evaluate` runs it (the
`Predictor`'s forward on the host-normalized feed, bf16 autocast unless
`--no_amp`).
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import numpy as np
import torch

from ..config import config_from_args
from ..data import CropDataset, Decoder, ValidationAugmentation
from ..data.pipeline import flatten_annotation
from ..evaluation import Evaluator
from ..ops.decode import split_head_output
from ..ops.encode import encode_targets
from ..utils import resolve_device


def _summ(ev: Evaluator) -> dict:
    s = ev.scalar_summary()
    keys = ("anchor/f1_total", "part/f1_total", "kps/f1_total",
            "csi/f1_total", "classif/f1_total")
    return {k: round(s.get(k, 0.0), 4) for k in keys}


def _with_scores(annotation):
    """Deep-copied GT with score=1.0 everywhere (the evaluator sorts
    predictions by score)."""
    ann = copy.deepcopy(annotation)
    for obj in ann.objects:
        obj.anchor.score = 1.0
        for p in obj.parts:
            p.score = 1.0
    return ann


def dense_maps_from_gt(config, annotation, device="cpu"):
    """'Perfect' head-output maps of one GT annotation, NCHW with a batch
    of 1 on `device`: Gaussian heatmaps turned back into logits, offsets
    and embeddings scattered at the keypoint pixels (zero elsewhere).
    Returns (maps, FlatKeypoints)."""
    in_w, in_h = config.width, config.height
    out_w, out_h = int(in_w / config.down_ratio), int(in_h / config.down_ratio)
    kp = flatten_annotation(
        copy.deepcopy(annotation),
        labels=config.labels, parts=config.parts,
        max_objects=config.max_objects, max_parts=config.max_parts,
        in_size=(in_w, in_h), out_size=(out_w, out_h),
    )
    enc = encode_targets(
        *(torch.from_numpy(np.asarray(a))[None] for a in kp),
        out_h=out_h, out_w=out_w,
        n_labels=len(config.labels), n_parts=len(config.parts),
        sigma_gauss=config.sigma_gauss,
    )
    anchor_hm = enc.anchor_hm[0].numpy()
    part_hm = enc.part_hm[0].numpy()

    offsets = np.zeros((2, out_h, out_w), np.float32)
    embeddings = np.zeros((2, out_h, out_w), np.float32)
    for i in range(config.max_objects):
        if not kp.anchor_mask[i]:
            continue
        x, y = kp.anchors_xy[i]
        ix, iy = int(np.floor(x)), int(np.floor(y))
        offsets[:, iy, ix] = (x - ix, y - iy)
    for i in range(config.max_parts):
        if not kp.part_mask[i]:
            continue
        x, y = kp.parts_xy[i]
        ix, iy = int(np.floor(x)), int(np.floor(y))
        offsets[:, iy, ix] = (x - ix, y - iy)
        embeddings[:, iy, ix] = kp.part_owner_xy[i] - kp.parts_xy[i]

    def to_logit(p):
        p = np.clip(p, 1e-6, 1.0 - 1e-6)
        return np.log(p / (1.0 - p)).astype(np.float32)

    maps = {"anchor_hm": to_logit(anchor_hm), "part_hm": to_logit(part_hm),
            "offsets": offsets, "embeddings": embeddings}
    return {k: torch.from_numpy(v)[None].to(device) for k, v in maps.items()}, kp


def grouping_rate(config, decoder, outputs, annotation):
    """Direct part -> parent accuracy: for each decoded part matched to a
    GT part (within the eval distance), did its assigned parent anchor
    land within the threshold of that GT part's owner anchor?
    Returns (correct, unassigned, total)."""
    dec = decoder.decode_arrays(
        outputs, config.conf_threshold, config.decoder_dist_thresh
    )
    anchors, parts, parent, valid = (
        dec[k].cpu().numpy() for k in ("anchors", "parts", "part_parent", "part_valid"))
    out_h, out_w = outputs["anchor_hm"].shape[2:]
    sx, sy = config.width / out_w, config.height / out_h

    gt_parts, gt_owner, gt_kind = [], [], []
    for obj in annotation.objects:
        for p in obj.parts:
            gt_parts.append((p.x, p.y))
            gt_owner.append((obj.x, obj.y))
            gt_kind.append(config.parts.get(p.kind, -1))
    if not gt_parts:
        return 0, 0, 0
    gt_parts = np.array(gt_parts)
    gt_owner = np.array(gt_owner)
    gt_kind = np.array(gt_kind)
    thresh = min(config.width, config.height) * config.dist_threshold

    total = correct = unassigned = 0
    for i in range(parts.shape[1]):
        if parts[0, i, 2] <= config.conf_threshold:
            continue
        px, py = parts[0, i, 0] * sx, parts[0, i, 1] * sy
        d = np.hypot(gt_parts[:, 0] - px, gt_parts[:, 1] - py)
        # match per kind, as Evaluator.eval_grouping does: a decoded leaf
        # must not claim a neighbouring object's part as its GT match
        d = np.where(gt_kind == int(parts[0, i, 3]), d, np.inf)
        j = int(d.argmin())
        if d[j] >= thresh:
            continue
        total += 1
        if not valid[0, i]:
            unassigned += 1
            continue
        a = anchors[0, int(parent[0, i])]
        ax, ay = a[0] * sx, a[1] * sy
        if np.hypot(ax - gt_owner[j, 0], ay - gt_owner[j, 1]) < thresh:
            correct += 1
    return correct, unassigned, total


def _rate(correct: int, unassigned: int, total: int) -> dict:
    return {"correct_parent": correct, "unassigned": unassigned, "total": total,
            "rate": round(correct / total, 4) if total else None}


def _accumulate(ev: Evaluator, decoder: Decoder, outputs, ann) -> None:
    data = decoder(outputs, return_metadata=True)
    ev.accumulate(data["annotation"][0], ann, data["raw_parts"][0],
                  eval_csi=True, eval_classif=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="ABD", help="subset of ABCD to run")
    ap.add_argument("--limit", type=int, default=0, help="max images (0=all)")
    ap.add_argument("--out", default=None, help="write JSON summary here")
    ap.add_argument("--device", type=str, default="cuda",
                    help="Device the model and the decodes run on ('cuda' or 'cpu').")
    args, rest = ap.parse_known_args(argv)
    config = config_from_args(rest)
    if not config.valid_dir:
        raise SystemExit("oracle_grouping requires --valid_dir")
    device = resolve_device(args.device)

    augmentation = ValidationAugmentation(config)
    dataset = CropDataset(config, config.valid_dir, augmentation)
    decoder = Decoder(config)
    results: dict = {}

    n = len(dataset) if not args.limit else min(args.limit, len(dataset))

    if "A" in args.arms:
        ev = Evaluator(config)
        for i in range(n):
            ann = dataset[i]["annotation"]
            pred = _with_scores(ann)
            raw = [copy.deepcopy(p) for o in pred.objects for p in o.parts]
            ev.accumulate(pred, ann, raw, eval_csi=True, eval_classif=True)
        results["A_gt_through_evaluator"] = _summ(ev)
        print("A (GT->Evaluator):", results["A_gt_through_evaluator"])

    if "B" in args.arms:
        ev = Evaluator(config)
        g = np.zeros(3, np.int64)
        for i in range(n):
            ann = dataset[i]["annotation"]
            outputs, _ = dense_maps_from_gt(config, ann, device)
            _accumulate(ev, decoder, outputs, ann)
            g += grouping_rate(config, decoder, outputs, ann)
        results["B_gt_encode_decode"] = _summ(ev)
        results["B_grouping_rate"] = _rate(*map(int, g))
        print("B (GT->encode->decode->Evaluator):", results["B_gt_encode_decode"])
        print("B grouping rate:", results["B_grouping_rate"])

    if "C" in args.arms or "D" in args.arms:
        if not config.pretrained_model:
            raise SystemExit("arms C/D need --load_model")
        from ..predictor import Predictor

        # the host normalizes in float32, as cli.evaluate feeds its forward
        predictor = Predictor(config, device=device, device_normalize=False)
        evals = {k: Evaluator(config) for k in ("C1", "C2", "D")}
        g = np.zeros(3, np.int64)
        for i in range(n):
            sample = dataset[i]
            ann = sample["annotation"]
            head = predictor.forward(predictor.to_device(sample["image"][None]))
            outputs = split_head_output(head, config.n_labels, config.n_parts)
            gt_maps, _ = dense_maps_from_gt(config, ann, device)

            if "D" in args.arms:
                _accumulate(evals["D"], decoder, outputs, ann)
                g += grouping_rate(config, decoder, outputs, ann)
            if "C" in args.arms:
                _accumulate(evals["C1"], decoder,
                            dict(outputs, embeddings=gt_maps["embeddings"]), ann)
                _accumulate(evals["C2"], decoder,
                            dict(gt_maps, embeddings=outputs["embeddings"]), ann)

        if "D" in args.arms:
            results["D_model_control"] = _summ(evals["D"])
            results["D_grouping_rate"] = _rate(*map(int, g))
            print("D (model control):", results["D_model_control"])
            print("D grouping rate:", results["D_grouping_rate"])
        if "C" in args.arms:
            results["C1_pred_hm_gt_emb"] = _summ(evals["C1"])
            results["C2_gt_hm_pred_emb"] = _summ(evals["C2"])
            print("C1 (pred heatmaps + GT embeddings):", results["C1_pred_hm_gt_emb"])
            print("C2 (GT heatmaps + pred embeddings):", results["C2_gt_hm_pred_emb"])

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
