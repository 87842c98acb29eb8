"""The readings a cell's limits are set from: the compared numbers of many
seeds, in one process, for the program as the configuration states it and
for the control (the lower precision: the program's int8 convolutions for
inference, the reference in float8 for training).

    python3 -m sdbench.readings --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

With `--fault NAME` a fault of `sdbench.faults` is planted in the
program. Prints one JSON line a seed: {"seed", "control", "fault",
"correct", "numbers" (every number the check read), "metrics"}. It is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

from . import run
from .faults import FAULTS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), help="plant a fault in the program")
    args = p.parse_args(argv)
    run.set_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("sdbench.readings needs a CUDA device", file=sys.stderr)
        return 2
    from structuredetector_tpu_torch.utils import set_build_dir

    set_build_dir(run.CACHE / "build")
    cell = run.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        fault = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with fault, tempfile.TemporaryDirectory(prefix="sdbench-") as tmp:
            t0 = time.perf_counter()
            numbers = {}
            r = run.execute(cell, seed, args.seconds, False, "cuda", Path(tmp), t_start=t0,
                            control=args.control, numbers_out=numbers)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": r["correct"], "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
