"""Device selection for the port's entry points, the one host->device
stager of its batches (`to_device`), the directory its native builds
live in, and the host helpers of JAX `utils.py` (reference
`utils.py:311-338`)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

# The CUDA kernels (`ops/kernels/_build.py`) and the native I/O library
# (`data/native.py`) are compiled on first use into this directory, one
# file a source named after a hash of what went into it, so a build is
# reused by every later process that finds it there.
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_build_dir = DEFAULT_BUILD_DIR


def build_dir() -> Path:
    """Where native builds are looked up and written."""
    return _build_dir


def set_build_dir(path) -> None:
    """Look up and write native builds under `path` (`--compile_cache`),
    so a fresh checkout reuses them. Call it before the first build: a
    library already loaded in this process stays loaded."""
    global _build_dir
    _build_dir = Path(path).expanduser().resolve()


def package_env() -> dict:
    """This process's environment with the directory that holds the
    package first on PYTHONPATH, so a `python -m structuredetector_tpu_torch
    ...` subprocess imports this copy from any working directory."""
    root = str(Path(__file__).resolve().parents[1])
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": root + (os.pathsep + path if path else "")}


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`. A CUDA device on a host without CUDA
    raises: the port never moves to the CPU unless the caller asks. Under
    torchrun, "cuda" without an index is the rank's card,
    `cuda:(LOCAL_RANK % device_count)`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu) to run the port on the CPU"
        )
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def to_device(arrays, device: torch.device) -> torch.Tensor:
    """Host arrays -> one tensor on `device`: a sequence of same-shaped
    arrays is stacked, one array is made contiguous. On CUDA the host
    tensor is pinned and copied with `non_blocking=True`, so the copy
    queues on the stream behind the running work instead of blocking
    this thread on it; on the CPU the host tensor is returned."""
    array = np.ascontiguousarray(arrays) if isinstance(arrays, np.ndarray) else np.stack(arrays)
    tensor = torch.from_numpy(array)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor


def progress(iterable, total: int, desc: str, every: int = 10, show: bool = True):
    """Yield from `iterable`, printing `desc: i/total` to stderr at the
    first item, then every `every` items and at the last (plain lines:
    the port needs no tqdm); nothing is printed unless `show`."""
    import sys

    for i, item in enumerate(iterable, start=1):
        yield item
        if show and (i == 1 or i % every == 0 or i == total):
            print(f"{desc}: {i}/{total}", file=sys.stderr, flush=True)


class AverageMeter:
    """Running average accumulator (reference utils.py:311-324)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, value):
        self.sum += value
        self.count += 1
        self.avg = self.sum / self.count
        return self.avg


def set_seed(seed: int = 926354916) -> torch.Generator:
    """Seed numpy's global RNG and torch's (the reference seeds torch,
    numpy and CUDA globally, utils.py:335-338) and return a
    `torch.Generator` seeded with `seed`. JAX `set_seed` returns a JAX
    root PRNG key there, which the port, importing no JAX, cannot."""
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def mkdir_if_needed(directory):
    Path(directory).mkdir(exist_ok=True)
