"""The benchmark's Swin cell, `swinv2b-infer-b32`, rehearsed on the CPU: its
driver (`sdbench/kinds/infer_swinv2.py`) at 64x64 with the committed
files cut to a small encoder (embed 32, blocks (2, 2, 2, 2)), float32, so
the program and the reference agree to rounding:

- the result line's schema with the trace off and on, `correct`, and no
  JAX or JAX package in a process that ran it;
- a broken timed path comes out not correct (`sdbench.faults`);
- the operation counts against torchvision's published 20.32 GFLOPS of
  `swin_v2_b` at 256x256;
- the cell's entries in `BENCHMARK.json`.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import pytest
import torch

from sdbench import counts_swinv2, run
from sdbench.faults import altered_answers, half_batch_answers
from sdbench.reference.swinv2 import ARCHS
from structuredetector_tpu_torch.models import swin

CELL = "swinv2b-infer-b32"
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
TINY = {"width": 64, "height": 64, "fpn_depth": 32, "dtype": "float32",
        "embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8]}
TINY_TRAFFIC = {"batch": 4, "frames": 16, "check_batches": 2}


@pytest.fixture(autouse=True)
def tiny_encoder(monkeypatch):
    """The program's `swin_v2_b` at the tiny cell's sizes, two threads. This
    suite's process holds JAX (`conftest.py`), so the run's look for it is
    left out here; `test_no_jax_in_a_rehearsal` makes it in a process of
    its own."""
    monkeypatch.setitem(swin.ARCHS, "swin_v2_b", swin.SwinSpec(32, (2, 2, 2, 2), (1, 2, 4, 8)))
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cell() -> run.Cell:
    cell = run.Cell(CELL)
    cell.config.update(TINY)
    cell.traffic.update(TINY_TRAFFIC)
    return cell


def tiny_run(cell, trace=False, seed=2 ** 31 + 17):
    from structuredetector_tpu_torch.utils import set_build_dir

    set_build_dir(Path(tempfile.gettempdir()) / "sdbench-test-build")
    with tempfile.TemporaryDirectory() as tmp:
        return run.execute(cell, seed, 1.0, trace, "cpu", Path(tmp),
                           t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    c = tiny_cell()
    r = tiny_run(c, trace=trace)
    assert list(r)[-1] == "checks" and all(k in r for k in KEYS)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"logit_miss", "pos_miss", "count_gap"}
    if trace:
        # a CPU trace has no device operations: the device readers give
        # nothing, the host clock's share of the peak does
        assert set(r["metrics"]) == {"mfu_swinv2.infer"}
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == {"infer_img_per_s", "setup_s"}
    json.dumps(r, allow_nan=False)


def test_no_jax_in_a_rehearsal(tmp_path):
    """A process of its own runs the driver, its look for JAX included, and
    lists what it holds of JAX or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        from sdbench import run
        from structuredetector_tpu_torch.models import swin
        from tests.test_sdbench_swinv2 import tiny_cell, tiny_run
        if __name__ == "__main__":
            swin.ARCHS["swin_v2_b"] = swin.SwinSpec(32, (2, 2, 2, 2), (1, 2, 4, 8))
            torch.set_num_threads(2)
            r = tiny_run(tiny_cell())
            print(r["correct"], run.forbidden_modules())
    """)
    script = tmp_path / "rehearse.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=run.ROOT, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(run.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


@pytest.mark.parametrize("fault", [altered_answers, half_batch_answers],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault):
    with fault():
        r = tiny_run(tiny_cell())
    assert r["correct"] is False, r["checks"]


def test_counts_match_torchvisions_published_count():
    """torchvision lists swin_v2_b at 20.32 GFLOPS (multiply-adds) at
    256x256 with its classifier; the count here reads 20.33."""
    macs = counts_swinv2.encoder_macs(ARCHS["swin_v2_b"], 256, 256, classes=1000)
    assert abs(macs / 20.32e9 - 1) < 0.01
    # the cell's 512x512: 81.1 GMACs of encoder a frame, the attention core
    # 4.2 GFLOP and 130 MB of q, k, v and output in bf16
    assert abs(counts_swinv2.encoder_macs(ARCHS["swin_v2_b"], 512, 512) / 81.1e9 - 1) < 0.01
    flops, nbytes, blocks = counts_swinv2.attention_core(ARCHS["swin_v2_b"], 512, 512, 1)
    assert blocks == 24 and abs(flops / 4.16e9 - 1) < 0.01
    assert 130e6 < nbytes < 140e6


def test_benchmark_entries():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "sdnet-swinv2-b"
    config = json.loads((run.HERE / "configs" / "sdnet-swinv2-b.json").read_text())
    assert config["backbone"] == "swin_v2_b" and config["reduced"] == []
    mine = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if CELL in m.get("workloads", [CELL])}
    assert mine == {"infer_img_per_s", "setup_s", "device_idle.infer", "idle_gc.infer",
                    "idle_submit.infer", "idle_materialize.infer", "decode_roofline.infer",
                    "mfu_swinv2.infer", "attn_roofline.infer", "attn_share.infer"}
    for m in bench["per_layer"]:
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
