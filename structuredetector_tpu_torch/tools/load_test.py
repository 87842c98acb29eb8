"""Serving load test: concurrent clients, latency percentiles.

    python -m structuredetector_tpu_torch.tools.load_test \\
        --load_model M.msgpack|--artifact M.sdz [--clients 32] [--duration 30] \\
        [--sweep 8,32,128] [--out load.json] [--device cpu] [-- serve flags]

The port of the JAX repo's `tools/load_test.py`. It starts the port's
`cli.serve` (a checkpoint or an `.sdz` artifact) as a subprocess on
`--device`, waits for GET /healthz, then runs `--clients` threads that
each POST one JPEG a request to /detect for `--duration` seconds, and
reports p50/p95/p99 client latency, served images a second, errors, and
the server's own micro-batch counters and submit-to-done latency from
/healthz. `--sweep` repeats the run over several `--max_batch` values;
one markdown table is printed and `--out` writes it with every run's
keys (`runs[*]`, as the JAX tool's). A server that exits before it is
healthy raises with its log (`--log_dir/serve_b<max_batch>.log`).
`--port 0` takes a free port.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ..utils import package_env

SERVE_COMMAND = [sys.executable, "-m", "structuredetector_tpu_torch.cli.serve"]


def make_jpeg(size: int = 512) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_healthy(host: str, port: int, timeout_s: float = 600.0, proc=None) -> dict:
    """The /healthz body once it answers 200. Raises if `proc` exits first
    or `timeout_s` passes."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the server exited with code {proc.returncode} "
                               "before it was healthy")
        try:
            conn = http.client.HTTPConnection(host, port, timeout=5)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            if resp.status == 200:
                return body
        except OSError:
            pass
        time.sleep(1.0)
    raise TimeoutError(f"server on {host}:{port} never became healthy")


def client_loop(host, port, payload, stop, latencies, errors):
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request("POST", "/detect", body=payload,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            if resp.status == 200:
                latencies.append(time.monotonic() - t0)
            else:
                errors.append(resp.status)
        except OSError as e:
            errors.append(str(e))


def run_one(args, max_batch: int) -> dict:
    port = args.port or free_port()
    serve_cmd = SERVE_COMMAND + [
        "--host", args.host, "--port", str(port), "--device", args.device,
        "--max_batch", str(max_batch),
        "--batch_window_ms", str(args.batch_window_ms),
    ]
    if args.artifact:
        serve_cmd += ["--artifact", args.artifact]
    else:
        serve_cmd += ["--load_model", args.load_model,
                      "--labels", args.labels, "--anchor_name", args.anchor_name]
    serve_cmd += args.serve_args

    log_path = args.log_dir / f"serve_b{max_batch}.log"
    log = open(log_path, "w")
    proc = subprocess.Popen(serve_cmd, stdout=log, stderr=subprocess.STDOUT, env=package_env())
    try:
        try:
            wait_healthy(args.host, port, proc=proc)
        except (RuntimeError, TimeoutError) as e:
            log.flush()
            raise RuntimeError(f"{e}; {log_path}:\n{log_path.read_text()[-3000:]}") from None
        payload = make_jpeg(args.image_size)

        latencies: list[float] = []
        errors: list = []
        stop = threading.Event()
        threads = [
            threading.Thread(
                target=client_loop,
                args=(args.host, port, payload, stop, latencies, errors),
                daemon=True,
            )
            for _ in range(args.clients)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(args.duration)
        stop.set()
        for t in threads:
            t.join(timeout=130)
        elapsed = time.monotonic() - t0

        health = wait_healthy(args.host, port, timeout_s=30, proc=proc)
        lat = sorted(latencies)

        def pct(p):
            return lat[min(len(lat) - 1, int(p / 100 * len(lat)))] if lat else float("nan")

        return {
            "max_batch": max_batch,
            "requests": len(lat),
            "errors": len(errors),
            "error_sample": errors[:5],
            "img_per_s": len(lat) / elapsed,
            "p50_ms": pct(50) * 1e3,
            "p95_ms": pct(95) * 1e3,
            "p99_ms": pct(99) * 1e3,
            "mean_ms": statistics.fmean(lat) * 1e3 if lat else float("nan"),
            "server_batches": health.get("batches_run"),
            "server_mean_batch": (
                health.get("images_run", 0) / health["batches_run"]
                if health.get("batches_run") else float("nan")
            ),
            # server-side submit->done percentiles (without the HTTP and
            # decode time the client numbers include), from /healthz
            "server_latency": health.get("latency"),
        }
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", type=str, default=None)
    src.add_argument("--load_model", type=str, default=None)
    p.add_argument("--labels", type=str, default="labels.json")
    p.add_argument("--anchor_name", type=str, default="stem")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--sweep", type=str, default=None,
                   help="Comma-separated max_batch values, e.g. 8,32,128.")
    p.add_argument("--log_dir", type=Path, default=Path("_runs"))
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the server runs on ('cuda' or 'cpu').")
    p.add_argument("serve_args", nargs="*", default=[],
                   help="Extra flags forwarded to the serve subprocess "
                        "after '--', e.g. -- --width 256 --int8.")
    args = p.parse_args(argv)
    args.log_dir.mkdir(parents=True, exist_ok=True)

    batches = [int(b) for b in args.sweep.split(",")] if args.sweep else [32]
    results = [run_one(args, b) for b in batches]

    cols = ("max_batch", "requests", "errors", "img_per_s",
            "p50_ms", "p95_ms", "p99_ms", "server_mean_batch")
    lines = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for r in results:
        lines.append("| " + " | ".join(
            f"{r[c]:.1f}" if isinstance(r[c], float) else str(r[c]) for c in cols
        ) + " |")
    table = "\n".join(lines)
    print()
    print(table)
    payload = {"table": table, "runs": results}
    if args.out:
        args.out.write_text(json.dumps(payload, indent=2))
    return payload


if __name__ == "__main__":
    main()
