"""The accuracy chain: data, a supervised train, the gate, the oracle arms,
the serve load test and the conf sweep, on the port.

    python -m structuredetector_tpu_torch.tools.accuracy_run \\
        [--data _runs/synth512v6] [--train 1200] [--valid 100] [--epochs 100] \\
        [--seed 20260818] [--device cuda] [--out _runs] [-- extra train flags]

The port of the JAX repo's `tools/regen_evidence.sh` (without its
transfer probe). Stages, in order, each through the port's own entry
points on `--device`:

1. dataset: `tools.synthetic_dataset` renders `--train` + `--valid`
   images into `--data` from the data seed 926354916 (skipped when
   `train/im_{N-1:04d}.json` exists);
   the SHA-256 of the first train image's pixels and objects is printed;
2. train: `tools.supervise` runs `cli.train` (at most 5 restarts after
   a stall exit 87, resumed) with the flagship recipe: `--hm_loss_fn focal
   --batch_size 32 --eval_batch_size 8 --embedding_weight 1.0
   --stall_timeout_s 900`, `--labels`, `--anchor_name stem`, then the
   flags after `--`; the run must write `model_best_csi.msgpack` (a run
   whose CSI never rose above 0 writes none, and the chain fails);
3. gate: `tools.accuracy_gate` on that checkpoint (four arms, floors);
4. oracle: `tools.oracle_grouping --arms CD` at conf 0.4;
5. load test: `tools.load_test` against `cli.serve` on the checkpoint
   (`--sweep`, `--clients`, `--duration`); every run must answer with no
   error;
6. sweep: `cli.evaluate --conf_sweep 0.2,0.25,0.3,0.4,0.5`.

Results go under `--out` with the JAX names and a `torch_` prefix:
`eval/torch_gate_r4_embw1{S}.json`, `eval/torch_oracle_r4_CD{S}.json`,
`torch_load_test_r4b{S}.json`, `eval/torch_sweep_r4{S}.json`, and the
chain's own record `torch_accuracy_run{S}.json` (stage wall times, the
image digest, the run directory, the gate's verdict), where S is
`.e{epochs}` unless `--epochs 100` (only the 100-epoch recipe writes
the flagship names), then `--suffix`. Logs (`*.log`) sit beside them.
`--width`, `--height` and `--fpn_depth` reach every stage (the CPU
drive: `--device cpu --width 64 --height 64 --fpn_depth 32`). An
exception in any stage ends the chain; a gate whose floors fail lets the
later stages run and the chain exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

from . import accuracy_gate, load_test, oracle_grouping, supervise, synthetic_dataset

TRAIN_RECIPE = ["--anchor_name", "stem", "--hm_loss_fn", "focal", "--batch_size", "32",
                "--eval_batch_size", "8", "--embedding_weight", "1.0",
                "--stall_timeout_s", "900"]
SWEEP = "0.2,0.25,0.3,0.4,0.5"
MAX_RESTARTS = 5  # train_supervised.sh -n 5


class _Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


@contextlib.contextmanager
def _logged(path: Path):
    """Standard output of the block copied into `path`."""
    with open(path, "w") as log, contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        yield


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=Path, default=Path("_runs/synth512v6"))
    p.add_argument("--train", type=int, default=1200)
    p.add_argument("--valid", type=int, default=100)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=20260818, help="The training seed.")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=Path, default=Path("_runs"))
    p.add_argument("--suffix", type=str, default="",
                   help="Appended to every result name (e.g. .s20260818).")
    p.add_argument("--labels", type=Path, default=Path("labels.json"))
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--fpn_depth", type=int, default=128)
    p.add_argument("--oracle_arms", type=str, default="CD")
    p.add_argument("--sweep", type=str, default="32,64,128",
                   help="The load test's max_batch values.")
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--duration", type=float, default=25.0)
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="Extra cli.train flags, after --.")
    args = p.parse_args(argv)
    if args.train_args[:1] == ["--"]:
        args.train_args = args.train_args[1:]
    return args


def run(args) -> dict:
    """The chain. Returns its record; raises when a stage fails."""
    from ..utils import resolve_device

    resolve_device(args.device)
    suffix = ("" if args.epochs == 100 else f".e{args.epochs}") + args.suffix
    out, data, labels = args.out.resolve(), args.data.resolve(), args.labels.resolve()
    (out / "eval").mkdir(parents=True, exist_ok=True)
    train_dir, valid_dir = data / "train", data / "valid"
    model = ["--width", str(args.width), "--height", str(args.height),
             "--fpn_depth", str(args.fpn_depth)]
    names = {"gate": out / "eval" / f"torch_gate_r4_embw1{suffix}.json",
             "oracle": out / "eval" / f"torch_oracle_r4_CD{suffix}.json",
             "load_test": out / f"torch_load_test_r4b{suffix}.json",
             "sweep": out / "eval" / f"torch_sweep_r4{suffix}.json",
             "record": out / f"torch_accuracy_run{suffix}.json"}
    record = {"args": {k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()},
              "results": {k: str(v) for k, v in names.items()}, "stages_s": {}}

    def stage(name):
        print(f"[accuracy_run] {name} at {time.strftime('%H:%M:%S')}", flush=True)
        return time.perf_counter()

    def done(name, t0):
        record["stages_s"][name] = time.perf_counter() - t0
        names["record"].write_text(json.dumps(record, indent=2))

    t0 = stage("dataset")
    record["image_digest"] = synthetic_dataset.first_image_digest()
    print(f"[accuracy_run] first train image: {json.dumps(record['image_digest'])}",
          flush=True)
    if (train_dir / f"im_{args.train - 1:04d}.json").exists():
        record["dataset"] = "present"
    else:
        seed = synthetic_dataset.DEFAULT_SEED
        synthetic_dataset.write_split(train_dir, args.train, seed)
        synthetic_dataset.write_split(valid_dir, args.valid, seed + 1)
        record["dataset"] = "rendered"
    done("dataset", t0)

    t0 = stage("train")
    train_argv = ["--device", args.device, "--train_dir", str(train_dir),
                  "--valid_dir", str(valid_dir), "--labels", str(labels), *TRAIN_RECIPE,
                  "--epochs", str(args.epochs), "--seed", str(args.seed), *model,
                  *args.train_args]
    with open(out / f"torch_train_r4_embw1{suffix}.log", "w") as log:
        rc, run_dir = supervise.supervise(train_argv, MAX_RESTARTS, log=log)
    record["run_dir"] = str(run_dir)
    done("train", t0)
    if rc != 0:
        raise SystemExit(f"[accuracy_run] train exited {rc}; see {log.name}")
    ckpt = run_dir / "model_best_csi.msgpack" if run_dir is not None else None
    if ckpt is None or not ckpt.exists():
        raise SystemExit(f"[accuracy_run] no model_best_csi.msgpack in {run_dir}: CSI never "
                         f"rose above 0.0 in validation; see {log.name}")
    record["checkpoint"] = str(ckpt)

    t0 = stage("gate")
    with _logged(names["gate"].with_suffix(".log")):
        payload = accuracy_gate.gate(accuracy_gate.parse_args([
            str(ckpt), "--valid_dir", str(valid_dir), "--train_dir", str(train_dir),
            "--labels", str(labels), "--anchor_name", "stem", "-W", str(args.width),
            "-H", str(args.height), "--fpn_depth", str(args.fpn_depth),
            "--device", args.device, "--out", str(names["gate"])]))
    record["gate"] = payload["gate"]
    record["gate_table"] = payload["table"]
    done("gate", t0)

    t0 = stage("oracle")
    with _logged(names["oracle"].with_suffix(".log")):
        record["oracle"] = oracle_grouping.main([
            "--arms", args.oracle_arms, "--valid_dir", str(valid_dir),
            "--labels", str(labels), "--anchor_name", "stem", "--load_model", str(ckpt),
            "--conf_threshold", "0.4", "--device", args.device, "--out", str(names["oracle"]),
            *model])
    done("oracle", t0)

    t0 = stage("load_test")
    with _logged(names["load_test"].with_suffix(".log")):
        loads = load_test.main([
            "--load_model", str(ckpt), "--labels", str(labels), "--anchor_name", "stem",
            "--sweep", args.sweep, "--clients", str(args.clients),
            "--duration", str(args.duration), "--port", "0", "--device", args.device,
            "--log_dir", str(out), "--out", str(names["load_test"]), "--", *model])
    record["load_test"] = loads["table"]
    done("load_test", t0)
    bad = [r for r in loads["runs"] if r["errors"] or not r["requests"]]
    if bad:
        raise SystemExit(f"[accuracy_run] load test runs with errors or no answer: {bad}")

    t0 = stage("sweep")
    from ..cli import evaluate

    with _logged(names["sweep"].with_suffix(".log")):
        evaluate.main([
            "--device", args.device, "--valid_dir", str(valid_dir), "--load_model", str(ckpt),
            "--labels", str(labels), "--anchor_name", "stem", "--eval_batch_size", "8",
            "--conf_sweep", SWEEP, "--save_summary", str(names["sweep"]), *model])
    done("sweep", t0)
    print(f"[accuracy_run] done: gate {record['gate']}; {names['record']}", flush=True)
    return record


def main(argv=None) -> int:
    record = run(parse_args(argv))
    return 0 if record["gate"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
