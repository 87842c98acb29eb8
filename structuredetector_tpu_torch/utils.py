"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`. A CUDA device on a host without CUDA
    raises: the port never moves to the CPU unless the caller asks."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu) to run the port on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def progress(iterable, total: int, desc: str, every: int = 10):
    """Yield from `iterable`, printing `desc: i/total` to stderr at the
    first item, then every `every` items and at the last (plain lines:
    the port needs no tqdm)."""
    import sys

    for i, item in enumerate(iterable, start=1):
        yield item
        if i == 1 or i % every == 0 or i == total:
            print(f"{desc}: {i}/{total}", file=sys.stderr, flush=True)
