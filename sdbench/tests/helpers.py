"""Tiny cells for the CPU tests: the committed cells' files cut to 64x64
inputs, `fpn_depth` 16, float32 (so the program and the reference agree to
rounding), a few images and a one-second window."""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import torch

from sdbench import run

torch.set_num_threads(2)  # several test workers share the host's cores

TINY_CONFIG = {"width": 64, "height": 64, "fpn_depth": 16, "dtype": "float32"}
TINY_TRAFFIC = {
    "infer_stream": {"batch": 4, "frames": 16, "check_batches": 2},
    "train_epochs": {"batch_size": 4, "images": 16, "image_size": [64, 64]},
}
CELLS = ("r34-infer-b32", "r50-train-b32", "r34-train-b8")


def tiny_cell(name: str, root: Path = run.ROOT, **config) -> run.Cell:
    cell = run.Cell(name, root)
    cell.config.update(TINY_CONFIG, **config)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


def tiny_run(cell: run.Cell, seed: int = 2 ** 31 + 11, trace: bool = False,
             seconds: float = 1.0, numbers_out: dict = None) -> dict:
    from structuredetector_tpu_torch.utils import set_build_dir

    set_build_dir(Path(tempfile.gettempdir()) / "sdbench-test-build")
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(cell, seed, seconds, trace, "cpu", Path(tmp),
                           t_start=time.perf_counter(), numbers_out=numbers_out)
