"""Supervised training: relaunch `cli.train` after a stall abort, resumed.

    python -m structuredetector_tpu_torch.tools.supervise [-n MAX_RESTARTS] -- \\
        --train_dir D --valid_dir V --stall_timeout_s 900 [train flags]

The port of the JAX repo's `tools/train_supervised.sh`. It runs the
port's `cli.train` in a subprocess from the caller's working directory
(so `trainings/<timestamp>/` lands where a direct run would put it).
When the trainer's stall watchdog ends the run with exit code 87
(`train.trainer.STALL_EXIT_CODE`), it relaunches with `--resume <the run
directory>` at most MAX_RESTARTS times; a run directory without a full
state under `state/` yet starts fresh instead. Exit 0 ends the loop;
any other exit code is returned as it is, without a retry.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..utils import package_env

# the trainer's stall-watchdog exit code (train/trainer.py), kept here so
# this module imports nothing of the trainer
STALL_EXIT_CODE = 87
TRAIN_COMMAND = [sys.executable, "-m", "structuredetector_tpu_torch.cli.train"]


def _run_dirs(cwd: Path) -> set:
    root = cwd / "trainings"
    return {p for p in root.iterdir() if p.is_dir()} if root.is_dir() else set()


def _resumable(run_dir: Optional[Path]) -> bool:
    state = run_dir / "state" if run_dir is not None else None
    return state is not None and state.is_dir() and any(
        p.suffix == ".pt" for p in state.iterdir())


def supervise(train_argv: Sequence[str], max_restarts: int = 5, cwd=None,
              command: Optional[List[str]] = None, log=None) -> Tuple[int, Optional[Path]]:
    """Run the trainer until it exits 0, exits with another code than 87,
    or has been restarted `max_restarts` times; its output goes to the
    open file `log` when given. Returns (exit code, the run directory it
    wrote or None)."""
    cwd = Path(cwd or Path.cwd()).resolve()
    command = list(command or TRAIN_COMMAND)
    run_dir: Optional[Path] = None
    restarts = 0
    while True:
        argv = list(train_argv)
        if run_dir is not None:
            argv += ["--resume", str(run_dir)]
            print(f"[supervise] restart {restarts}: resuming {run_dir}", flush=True)
        else:
            print(f"[supervise] attempt {restarts + 1}: fresh run", flush=True)
        before = _run_dirs(cwd)
        t0 = time.monotonic()
        if log is not None:
            log.flush()
        rc = subprocess.run(command + argv, cwd=cwd, env=package_env(), stdout=log,
                            stderr=subprocess.STDOUT if log is not None else None).returncode
        print(f"[supervise] train exited rc={rc} after {time.monotonic() - t0:.1f}s",
              flush=True)
        if run_dir is None:
            new = sorted(_run_dirs(cwd) - before)
            run_dir = new[-1] if new else None
        if rc != STALL_EXIT_CODE:
            return rc, run_dir
        if restarts >= max_restarts:
            print(f"[supervise] giving up after {restarts} restarts", flush=True)
            return rc, run_dir
        if not _resumable(run_dir):
            print(f"[supervise] no resumable state in {run_dir}; the next run starts fresh",
                  flush=True)
            run_dir = None
        restarts += 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--max_restarts", type=int, default=5)
    p.add_argument("train_argv", nargs=argparse.REMAINDER,
                   help="cli.train's flags, after --")
    args = p.parse_args(argv)
    train_argv = args.train_argv[1:] if args.train_argv[:1] == ["--"] else args.train_argv
    rc, run_dir = supervise(train_argv, args.max_restarts)
    print(f"[supervise] rc={rc} run_dir={run_dir}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
