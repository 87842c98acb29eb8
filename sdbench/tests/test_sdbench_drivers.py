"""Tiny CPU rehearsals of every traffic driver: the result line's schema
with the trace off and on, the guard against JAX in the process, and that
a new cell of an existing kind needs only data files."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from sdbench import run
from sdbench.tests.helpers import CELLS, TINY_CONFIG, TINY_TRAFFIC, tiny_cell, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(cell, trace):
    c = tiny_cell(cell)
    r = tiny_run(c, trace=trace)
    assert list(r)[-1] == "checks"
    assert all(k in r for k in KEYS)
    assert r["correct"] is True, r["checks"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:
        assert set(r["metrics"]) <= names  # CPU runs have no device trace
        assert {"device_ops", "idle_gaps"} == set(r["breakdown"])
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == names and "setup_s" in names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


def test_no_jax_in_a_rehearsal_of_every_driver(tmp_path):
    """A process of its own runs every driver and then looks for JAX or the
    JAX package among its modules by whole top-level name."""
    import structuredetector_tpu_torch  # noqa: F401

    code = textwrap.dedent("""
        import sys
        from sdbench import run
        from sdbench.tests.helpers import CELLS, tiny_cell, tiny_run
        if __name__ == "__main__":
            for name in CELLS:
                tiny_run(tiny_cell(name), seconds=0.5)
            print(run.forbidden_modules())
    """)
    script = tmp_path / "rehearse.py"
    script.write_text(code)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=run.ROOT, timeout=900,
                         env={**os.environ, "PYTHONPATH": str(run.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # whole top-level names: the port's name begins with the JAX package's
    assert "structuredetector_tpu_torch" in sys.modules
    assert not any(m.split(".")[0] == "structuredetector_tpu_torch"
                   for m in run.forbidden_modules())
    sys.modules["structuredetector_tpu.fake"] = sys.modules["sdbench"]
    try:
        assert "structuredetector_tpu.fake" in run.forbidden_modules()
    finally:
        del sys.modules["structuredetector_tpu.fake"]


def _new_cell(tmp_path, limits):
    """A copy of the benchmark's data files with one more traffic file, one
    more BENCHMARK.json entry and, with `limits`, the new cell's own
    workload file."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(run.HERE / d, tmp_path / "sdbench" / d)
    traffic = json.loads((run.HERE / "traffic" / "stream_b32.json").read_text())
    traffic.update(TINY_TRAFFIC["infer_stream"], batch=8)
    (tmp_path / "sdbench" / "traffic" / "stream_b8_new.json").write_text(json.dumps(traffic))
    if limits is not None:
        (tmp_path / "sdbench" / "workloads" / "r50-infer-b8.json").write_text(
            json.dumps({"limits": limits}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "r50-infer-b8", "config": "sdnet-r50",
                               "traffic": "stream_b8_new", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "r34-infer-b32" in m.get("workloads", []):
            m["workloads"].append("r50-infer-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_cell_needs_only_data_files(tmp_path):
    """The new cell runs from data files alone; no code changes."""
    _new_cell(tmp_path, {"pos_miss": 0.001, "count_gap": 0})
    cell = run.Cell("r50-infer-b8", root=tmp_path)
    assert cell.limits == {"pos_miss": 0.001, "count_gap": 0}
    cell.config.update(TINY_CONFIG)
    r = tiny_run(cell)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"infer_img_per_s", "setup_s"}
    assert set(r["checks"]) == {"pos_miss", "count_gap"}


@pytest.mark.parametrize("limits", [None, {}])
def test_a_cell_without_limits_of_its_own_is_refused(tmp_path, limits):
    """Another cell's limits, on the same traffic mix, never stand in."""
    _new_cell(tmp_path, limits)
    with pytest.raises(SystemExit, match="no limits"):
        run.Cell("r50-infer-b8", root=tmp_path)
