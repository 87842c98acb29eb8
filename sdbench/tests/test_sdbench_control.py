"""The control comes out not correct at each cell's own size on three
seeds: for inference the program's int8 convolutions, for training the
reference with float8 convolution operands in the program's place. Needs
the card."""

import tempfile
import time
from pathlib import Path

import pytest

from sdbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["r34-infer-b32", "r50-train-b32", "r34-train-b8"])
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    from structuredetector_tpu_torch.utils import set_build_dir

    run.set_cache_env()
    set_build_dir(run.CACHE / "build")
    c = run.Cell(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        with tempfile.TemporaryDirectory() as tmp:
            r = run.execute(c, seed, 3.0, False, "cuda", Path(tmp),
                            t_start=time.perf_counter(), control=True)
        assert r["correct"] is False, (seed, r["checks"])
