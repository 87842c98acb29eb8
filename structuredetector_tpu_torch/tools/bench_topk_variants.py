"""The top-k kernel variants against each other on the card.

    python -m structuredetector_tpu_torch.tools.bench_topk_variants [--out FILE]

The port of `tools/bench_topk_variants.py`: at the batch-128 serving
shapes (512x512 input -> 128x128 planes; anchors C=2 k=20, parts C=1
k=40) both variants of `sigmoid_nms_topk` ("rounds", kernel B, and
"onehot", kernel C) must first equal the plain version bit for bit; then
each is timed with CUDA events. Prints one JSON line with the card's
name and power limit, each case's times and the faster variant. It
changes no default: `sigmoid_nms_topk` keeps "rounds".
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..ops.kernels import sigmoid_nms_topk, sigmoid_nms_topk_reference
from .timing import card, device_ms

BATCH, H, W = 128, 128, 128
CASES = (("anchors", 2, 20), ("parts", 1, 40))
VARIANTS = ("rounds", "onehot")
ITERS = 30


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the variant shootout times the kernels on a CUDA card; "
                           "none is available")
    rng = np.random.default_rng(0)
    result = {"card": card(), "kind": torch.cuda.get_device_name(0), "batch": BATCH,
              "plane": [H, W], "iters": ITERS, "ms": {}}
    for name, c, k in CASES:
        x = torch.from_numpy(rng.normal(0, 3, (BATCH * c, H, W)).astype(np.float32)).cuda()
        want = sigmoid_nms_topk_reference(x, k)
        for variant in VARIANTS:
            got = sigmoid_nms_topk(x, k, variant=variant)
            for g, w, what in zip(got, want, ("values", "indices")):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{name}/{variant}: {what} differ from the plain version")
        result["ms"][name] = {
            v: device_ms(lambda v=v: sigmoid_nms_topk(x, k, variant=v), iters=ITERS)
            for v in VARIANTS
        }
    total = {v: sum(case[v] for case in result["ms"].values()) for v in VARIANTS}
    result["total_ms"] = total
    result["faster"] = min(total, key=total.get)
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    result = run()
    line = json.dumps({"topk_variants": result})
    print(line, flush=True)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
