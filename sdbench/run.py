"""One run of one cell of `BENCHMARK.json`.

    python3 -m sdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(`sdbench/configs/<config>.json`) and a traffic mix
(`sdbench/traffic/<traffic>.json`, whose `kind` names the driver
`sdbench/kinds/<kind>.py`); its own file `sdbench/workloads/<cell>.json`
holds the limits of the numbers its check compares, set from that cell's
readings; each per-layer metric is read by `sdbench/metrics/<metric>.py`.
A new cell of an existing kind is data only: a workload file, an entry in
`BENCHMARK.json` and, for a new mix, a traffic file.

A run: set-up (inputs and weights from the seed, the program built and
every shape warmed), the measured window of `--seconds`, then the check
of what the window produced against the plain reference. It prints each
compared number beside its limit as the last lines of stderr, and one
JSON line last on stdout: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones under a
`torch.profiler` trace of the window), `device`, with `--trace 1`
`breakdown`, and `checks` last. It exits non-zero without a result where
the card is missing, or where the process holds JAX or the JAX package
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".sdbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "structuredetector_tpu")


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path):
    return json.loads(Path(path).read_text())


class Cell:
    """One entry of `BENCHMARK.json` with its configuration, traffic and
    workload files and the metrics the benchmark asks of it. A cell without
    limits of its own in its workload file is refused: limits are read from
    one cell's runs and hold for that cell alone."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
        self.name, self.chips = name, int(entry["chips"])
        self.config = load_json(root / "sdbench" / "configs" / f"{entry['config']}.json")
        self.traffic = load_json(root / "sdbench" / "traffic" / f"{entry['traffic']}.json")
        own = root / "sdbench" / "workloads" / f"{name}.json"
        self.limits = load_json(own).get("limits") if own.is_file() else None
        if not self.limits:
            raise SystemExit(f"no limits for {name!r}: {own} is missing or holds none")

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def driver(kind: str):
    return importlib.import_module(f"sdbench.kinds.{kind}")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"sdbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Context:
    """What a driver and a metric reader get: the cell's files, the seed,
    the device and a scratch directory for the run."""

    def __init__(self, cell: Cell, seed: int, device, run_dir: Path, control: bool = False,
                 seconds: float = 0.0):
        self.cell, self.seed, self.device, self.run_dir = cell, seed, device, run_dir
        self.seconds, self.root = seconds, ROOT
        self.config, self.traffic = cell.config, cell.traffic
        self.control = control
        self.workers = max(1, min(8, os.cpu_count() or 1))

    def port_config(self, **overrides):
        """The program's `Config` for this configuration."""
        from structuredetector_tpu_torch.config import Config

        c = self.config
        cfg = Config(width=c["width"], height=c["height"], fpn_depth=c["fpn_depth"],
                     down_ratio=c["down_ratio"], backbone=c["backbone"],
                     anchor_name=c["anchor_name"], max_objects=c["max_objects"],
                     max_parts=c["max_parts"], conf_threshold=c["conf_threshold"],
                     decoder_dist_thresh=c["decoder_dist_thresh"],
                     use_amp=c["dtype"] == "bfloat16", seed=self.seed, **overrides)
        cfg.set_labels(c["labels"], c["parts"])
        return cfg.finalize()

    @property
    def n_out(self) -> int:
        return len(self.config["labels"]) + len(self.config["parts"]) + 4


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            run_dir: Path, t_start: float = T_START, control: bool = False,
            numbers_out: dict = None) -> dict:
    """Set-up, window, check, metrics: the run past the look for a card
    (tests call it on the CPU). `numbers_out` receives every number the
    check read, with a limit or not."""
    import torch

    from . import trace as tracing

    ctx = Context(cell, seed, torch.device(device), run_dir, control, seconds)
    kind = driver(cell.traffic["kind"])
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = kind.setup(ctx)
    recorder = tracing.Recorder(trace, ctx.device)
    with recorder:
        window = kind.window(state, seconds, recorder)
    setup_s = window["start"] - t_start
    found = forbidden_modules()
    if found:
        print(f"sdbench: the process holds {found} after the window", file=sys.stderr)
        raise SystemExit(3)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    numbers = kind.check(state)
    if numbers_out is not None:
        numbers_out.update(numbers)
    del state
    gc.collect()
    from .compare import checks_from

    checks = checks_from(numbers, cell.limits)
    correct = all(c.ok for c in checks) and window["failed"] == 0
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"]}
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        reduced = recorder.reduce()
        mctx = tracing.MetricContext(ctx, window, reduced)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = reduced.breakdown()
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for line in window.get("notes", []):
        print(line, file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_env()
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sdbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from structuredetector_tpu_torch.utils import set_build_dir

    set_build_dir(CACHE / "build")
    with tempfile.TemporaryDirectory(prefix="sdbench-") as tmp:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", Path(tmp))
    print(f"card: {power_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
