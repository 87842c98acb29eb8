"""Device timing and the card's identity, for the port's measurements."""

from __future__ import annotations

import subprocess


def card() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of `fn()` over `iters` calls, CUDA events.

    The stream first runs a ~50 ms sleep kernel, so all `iters` calls are
    queued before the start event runs: the time is the device's, free of
    the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
