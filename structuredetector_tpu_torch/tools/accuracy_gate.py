"""Accuracy gate: a checkpoint against its exported artifacts, F1 by mode.

    python -m structuredetector_tpu_torch.tools.accuracy_gate CKPT.msgpack \\
        --valid_dir D --train_dir C [--labels labels.json] [--anchor_name stem] \\
        [--model_args '--head_conv 64'] [--out gate.json] [--device cpu]

The port of the JAX repo's `tools/accuracy_gate.py`, which mirrors the
reference's export-validation loop (it re-ran the full evaluator on the
exported CoreML model). Four arms on one validation set, each through
the port's own entry points, run in-process with the argv a shell would
give them:

- `checkpoint_bf16`: `cli.evaluate` on the checkpoint (bf16 autocast,
  kernel A's decode on the card);
- `sdz_float`, `int8_dynamic`, `int8_static`: `cli.convert_export` (the
  last with `--int8 --calibrate_dir <train_dir>`), then
  `cli.evaluate_export` on the artifact (a ragged last batch is padded).

Prints one table of F1 by family and mode with each mode's kps delta
from the checkpoint, and the verdict of the structural floors, which
hold the checkpoint row only. `--out` writes `table`, `summaries`,
`floors` and `gate` as JSON before a failing gate exits 1, in the JAX
tool's schema, so the two packages' gate files diff line by line.
"""

from __future__ import annotations

import argparse
import json
import shlex
import tempfile
from pathlib import Path

FAMILIES = ("anchor", "part", "kps", "csi", "classif")
MODES = ("checkpoint_bf16", "sdz_float", "int8_dynamic", "int8_static")

# Structural floors on the checkpoint row: a structure detector's gate
# must fail when structure regresses, not only keypoints. Override per
# call with --min_*.
DEFAULT_FLOORS = {
    "kps/f1_total": 0.70,
    "csi/f1_total": 0.50,
    "classif/f1_total": 0.30,
    "grouping/accuracy": 0.80,
}


def check_floors(base: dict, floors: dict):
    """Split floor checks into (skipped, failures).

    A metric absent from the summary is *not applicable* (e.g.
    grouping/accuracy is only emitted when at least one part matched;
    a parts-free dataset would otherwise always fail the grouping
    floor at a defaulted 0.0) — skipped, not failed.
    """
    skipped = [k for k in floors if k not in base]
    failures = [
        f"{key} {base[key]:.4f} < floor {floor:.2f}"
        for key, floor in floors.items()
        if key in base and base[key] < floor
    ]
    return skipped, failures


def run_evaluate(ckpt, args, out_json):
    from ..cli import evaluate

    evaluate.main([
        "--device", args.device,
        "--valid_dir", str(args.valid_dir), "--load_model", str(ckpt),
        "--labels", str(args.labels), "--anchor_name", args.anchor_name,
        "--width", str(args.width), "--height", str(args.height),
        "--fpn_depth", str(args.fpn_depth),
        "--max_objects", str(args.max_objects),
        "--max_parts", str(args.max_parts),
        "--conf_threshold", str(args.conf_threshold),
        "--dist_threshold", str(args.dist_threshold),
        "--decoder_dist_thresh", str(args.decoder_dist_thresh),
        "--eval_batch_size", str(args.batch_size),
        "--save_summary", str(out_json),
    ] + args.model_argv)
    return json.loads(Path(out_json).read_text())


def run_export_mode(ckpt, args, workdir, mode, out_json):
    from ..cli import convert_export, evaluate_export

    sdz = workdir / f"model_{mode}.sdz"
    argv = [
        str(ckpt), "--output", str(sdz), "--params", str(args.labels),
        "--anchor_name", args.anchor_name, "--batch_size", str(args.batch_size),
        "-W", str(args.width), "-H", str(args.height),
        "--fpn-depth", str(args.fpn_depth), "--device", args.device,
    ]
    if mode == "int8_dynamic":
        argv += ["--int8"]
    elif mode == "int8_static":
        argv += ["--int8", "--calibrate_dir", str(args.train_dir),
                 "--calibrate_images", str(args.calibrate_images)]
    # model-shape flags (e.g. --head_conv 64) so the rebuilt model matches
    # the checkpoint; evaluate_export needs none (the .sdz carries them)
    convert_export.main(argv + args.model_argv)

    evaluate_export.main([
        str(sdz), "--valid_dir", str(args.valid_dir),
        "--anchor_name", args.anchor_name,
        "--max_objects", str(args.max_objects),
        "--max_parts", str(args.max_parts),
        "--conf_threshold", str(args.conf_threshold),
        "--dist_threshold", str(args.dist_threshold),
        "--decoder_dist_thresh", str(args.decoder_dist_thresh),
        "--save_summary", str(out_json), "--device", args.device,
    ])
    return json.loads(Path(out_json).read_text())


def gate_table(results: dict) -> str:
    """The markdown table of F1 by family and mode, with the kps delta of
    each mode from the checkpoint row."""
    base = results["checkpoint_bf16"]
    header = ("| mode | " + " | ".join(f"{f} F1" for f in FAMILIES)
              + " | grouping | Δkps F1 |")
    sep = "|" + "---|" * (len(FAMILIES) + 3)
    lines = [header, sep]
    for mode, s in results.items():
        cells = [f"{s.get(f + '/f1_total', 0.0):.4f}" for f in FAMILIES]
        cells.append(f"{s.get('grouping/accuracy', 0.0):.4f}")
        delta = s.get("kps/f1_total", 0.0) - base.get("kps/f1_total", 0.0)
        lines.append(f"| {mode} | " + " | ".join(cells) + f" | {delta:+.4f} |")
    return "\n".join(lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", type=Path)
    p.add_argument("--valid_dir", type=Path, required=True)
    p.add_argument("--train_dir", type=Path, required=True,
                   help="Calibration images for the static-int8 mode.")
    p.add_argument("--labels", type=Path, default=Path("labels.json"))
    p.add_argument("--anchor_name", type=str, default="stem")
    p.add_argument("--width", "-W", type=int, default=512)
    p.add_argument("--height", "-H", type=int, default=512)
    p.add_argument("--fpn_depth", type=int, default=128)
    p.add_argument("--max_objects", type=int, default=20)
    p.add_argument("--max_parts", type=int, default=40)
    p.add_argument("--conf_threshold", type=float, default=0.4)
    p.add_argument("--dist_threshold", type=float, default=0.05)
    p.add_argument("--decoder_dist_thresh", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--calibrate_images", type=int, default=32)
    p.add_argument("--out", type=Path, default=None,
                   help="Also write the table + raw summaries as JSON.")
    p.add_argument("--model_args", type=str, default="",
                   help="Extra model-shape flags forwarded to evaluate "
                        "and convert_export as one quoted string, e.g. "
                        "--model_args '--head_conv 64' for checkpoints "
                        "trained with a deep head.")
    p.add_argument("--min_kps", type=float, default=DEFAULT_FLOORS["kps/f1_total"])
    p.add_argument("--min_csi", type=float, default=DEFAULT_FLOORS["csi/f1_total"])
    p.add_argument("--min_classif", type=float,
                   default=DEFAULT_FLOORS["classif/f1_total"])
    p.add_argument("--min_grouping", type=float,
                   default=DEFAULT_FLOORS["grouping/accuracy"])
    p.add_argument("--device", type=str, default="cuda",
                   help="Device every arm runs on ('cuda' or 'cpu').")
    args = p.parse_args(argv)
    args.model_argv = shlex.split(args.model_args)
    return args


def gate(args) -> dict:
    """Every arm, the table and the floors' verdict of parsed `args`; writes
    `args.out` when set. Returns the payload (`gate` starts with "FAIL"
    when a floor failed); an arm that fails raises."""
    from ..utils import resolve_device

    resolve_device(args.device)  # raises before any arm where CUDA is missing

    results = {}
    with tempfile.TemporaryDirectory() as td:
        workdir = Path(td)
        results["checkpoint_bf16"] = run_evaluate(
            args.checkpoint, args, workdir / "ckpt.json")
        for mode in MODES[1:]:
            results[mode] = run_export_mode(
                args.checkpoint, args, workdir, mode, workdir / f"{mode}.json")

    table = gate_table(results)
    print()
    print(table)

    floors = {
        "kps/f1_total": args.min_kps,
        "csi/f1_total": args.min_csi,
        "classif/f1_total": args.min_classif,
        "grouping/accuracy": args.min_grouping,
    }
    skipped, failures = check_floors(results["checkpoint_bf16"], floors)
    for key in skipped:
        print(f"gate: {key} not applicable on this dataset — floor skipped")
    verdict = "PASS" if not failures else "FAIL: " + "; ".join(failures)
    print(f"\ngate: {verdict}")

    payload = {"table": table, "summaries": results, "floors": floors, "gate": verdict}
    if args.out:
        args.out.write_text(json.dumps(payload, indent=2))
    return payload


def main(argv=None):
    payload = gate(parse_args(argv))
    if payload["gate"] != "PASS":
        raise SystemExit(1)
    return payload


if __name__ == "__main__":
    main()
