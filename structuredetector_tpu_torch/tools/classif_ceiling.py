"""Classification-metric ceiling analysis of a gate JSON.

    python -m structuredetector_tpu_torch.tools.classif_ceiling GATE.json \\
        [--mode checkpoint_bf16] [--out ceiling.json]

The port's own copy of the JAX repo's `tools/classif_ceiling.py`; it
reads a gate JSON of either package (`tools.accuracy_gate --out`). The
classification family buckets each object as `{label}_{n_parts}`
(reference `evaluator.py:422-474`), so a single missed or spurious leaf
moves the object one bucket over and costs a false-negative and
false-positive pair. With part -> parent grouping near 1.0 (oracle arm
D), part detection is what binds. The tool quantifies that ceiling:

  P(object lands in its own bucket)
    ~= r^n                 (all n true leaves found; r = part recall)
     * exp(-n r (1-p)/p)   (no spurious leaf attaches; detections per
                            object ~ n r, each spurious w.p. (1-p))

and sets the resulting per-bucket expectation beside the measured
per-bucket classification F1. Buckets that track the curve mean the
classification score is what the measured part P/R allows
(detection-limited), not a grouping defect.
"""

import argparse
import json
import math
import re
from pathlib import Path


def ceiling(n: int, r: float, p: float) -> float:
    if n == 0:
        return math.exp(-0.5 * (1 - p) / p)  # only spurious risk
    return (r ** n) * math.exp(-n * r * (1 - p) / p)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gate_json")
    ap.add_argument("--mode", default="checkpoint_bf16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    data = json.loads(Path(args.gate_json).read_text())
    s = data["summaries"][args.mode]
    r = s["part/recall_total"]
    p = s["part/precision_total"]

    rows = []
    for key, f1 in sorted(s.items()):
        m = re.match(r"classif/f1_(\w+)_(\d+)$", key)
        if not m:
            continue
        label, n = m.group(1), int(m.group(2))
        prec = s.get(f"classif/precision_{label}_{n}", 0.0)
        rec = s.get(f"classif/recall_{label}_{n}", 0.0)
        if prec == 0.0 and rec == 0.0 and f1 == 0.0:
            continue  # empty bucket (no GT, no detections)
        rows.append({
            "bucket": f"{label}_{n}", "n_parts": n,
            "measured_f1": round(f1, 4),
            "detection_ceiling": round(ceiling(n, r, p), 4),
        })

    # the summary has no per-bucket counts for a GT-weighted comparison:
    # the unweighted mean over non-empty buckets, on both sides
    mean_meas = sum(x["measured_f1"] for x in rows) / len(rows)
    mean_ceil = sum(x["detection_ceiling"] for x in rows) / len(rows)

    out = {
        "gate": args.gate_json, "mode": args.mode,
        "part_recall": round(r, 4), "part_precision": round(p, 4),
        "grouping_accuracy": s.get("grouping/accuracy"),
        "buckets": rows,
        "mean_measured_f1": round(mean_meas, 4),
        "mean_detection_ceiling": round(mean_ceil, 4),
        "verdict": (
            "detection-limited" if mean_meas >= 0.8 * mean_ceil
            else "unexplained-gap"),
    }
    print(json.dumps(out, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
