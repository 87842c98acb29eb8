"""The port's accuracy chain (`structuredetector_tpu_torch/tools/`) against
the JAX repo's `tools/`, on the CPU.

Small config (64x64 input, 16x16 grid, `fpn_depth` 32, K=4 anchors, P=8
parts) and one JAX `save_params` checkpoint of nontrivial weights; the
ground truth of its images is the JAX model's own fp32 detections, so
the counters hold true positives. The JAX tools are imported by path
here only:

- the renderer: equal arrays and objects for 3 seeds, byte-equal files
  from `write_split`;
- `classif_ceiling` on the committed JAX gate JSON: equal output;
- `check_floors`: equal verdicts, the absent-metric skip included;
- the gate on 3 images at batch 2 (a ragged last batch): four finite
  arms in JAX's schema and keys; its checkpoint arm, in fp32 through
  the gate's `--model_args` passthrough, equals JAX `cli.evaluate
  --save_summary` (every value within 1e-6, the bar of the evaluate
  parity test; the threshold stands clear of every fp32 score; why not
  in bf16: `test_gate_matches_jax`);
- the oracle: arms A and B equal; arm D and the grouping rate in fp32
  within 1e-6 (the same bar) at the same threshold;
- `supervise`: a restart with `--resume` after exit 87, none otherwise;
- `accuracy_run` end to end with a stub trainer that writes the
  checkpoint: every stage and result file, and its load test against
  the port's `cli.serve --device cpu` (2 clients, 2 s): no error, JAX's
  keys.
"""

import contextlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from structuredetector_tpu.cli import detect as jax_detect_cli
from structuredetector_tpu.cli import evaluate as jax_evaluate_cli
from structuredetector_tpu.models.network import save_params
from structuredetector_tpu_torch.tools import (
    accuracy_gate,
    accuracy_run,
    classif_ceiling,
    load_test,
    oracle_grouping,
    supervise,
    synthetic_dataset,
)
from tests.test_torch_port_evaluate import SIZES, _write_images
from tests.test_torch_port_model import nontrivial_variables

REPO = Path(__file__).resolve().parents[1]
MODEL = ["--width", "64", "--height", "64", "--fpn_depth", "32"]
DECODE = ["--max_objects", "4", "--max_parts", "8"]
# clear of every fp32 score the checkpoint gives these images by more than
# an ulp of sigmoid between XLA and torch (a test asserts it)
CONF = 0.35

def _jax_tool(name: str):
    """A module of the JAX repo's tools/, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _cwd(path: Path):
    old = Path.cwd()
    path.mkdir(parents=True, exist_ok=True)
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(old)


# ------------------------------------------------------------- the data

@pytest.mark.parametrize("seed", [0, 7, synthetic_dataset.DEFAULT_SEED])
def test_render_image_matches_jax(seed):
    jax_synth = _jax_tool("make_synthetic_dataset")
    want_img, want_objects = jax_synth.render_image(np.random.default_rng(seed))
    got_img, got_objects = synthetic_dataset.render_image(np.random.default_rng(seed))
    np.testing.assert_array_equal(np.asarray(got_img), np.asarray(want_img))
    assert got_objects == want_objects
    assert got_objects, "no plant drawn: the case tests little"


def test_write_split_matches_jax(tmp_path):
    jax_synth = _jax_tool("make_synthetic_dataset")
    for name, module in (("jax", jax_synth), ("port", synthetic_dataset)):
        with _cwd(tmp_path / name):  # image_path is written as given: relative here
            module.write_split(Path("split"), 3, 11)
    files = sorted(p.name for p in (tmp_path / "jax" / "split").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port" / "split").iterdir())
    assert len(files) == 6
    for f in files:
        assert (tmp_path / "port" / "split" / f).read_bytes() == \
            (tmp_path / "jax" / "split" / f).read_bytes(), f


def test_first_image_digest_is_the_first_train_image():
    digest = synthetic_dataset.first_image_digest(5)
    img, _ = synthetic_dataset.render_image(np.random.default_rng(5))
    import hashlib

    assert digest["array_sha256"] == hashlib.sha256(np.asarray(img).tobytes()).hexdigest()
    assert digest != synthetic_dataset.first_image_digest(6)


# ------------------------------------------------------- gate helpers

def test_classif_ceiling_matches_jax(capsys):
    gate = str(REPO / "_runs" / "eval" / "gate_r5_base40.json")
    want = _jax_tool("classif_ceiling").main([gate])
    got = classif_ceiling.main([gate])
    assert got == want
    assert got["buckets"] and got["verdict"] in ("detection-limited", "unexplained-gap")


FLOOR_CASES = [
    ({"kps/f1_total": 0.9}, {"kps/f1_total": 0.7, "grouping/accuracy": 0.8}),
    ({"kps/f1_total": 0.5, "grouping/accuracy": 0.9},
     {"kps/f1_total": 0.7, "grouping/accuracy": 0.8}),
    ({"kps/f1_total": 0.7, "csi/f1_total": 0.49999, "classif/f1_total": 0.3,
      "grouping/accuracy": 0.8}, accuracy_gate.DEFAULT_FLOORS),
    ({}, accuracy_gate.DEFAULT_FLOORS),
    ({"kps/f1_total": 0.0, "csi/f1_total": 0.0, "classif/f1_total": 0.0,
      "grouping/accuracy": 0.0}, accuracy_gate.DEFAULT_FLOORS),
]


@pytest.mark.parametrize("base,floors", FLOOR_CASES,
                         ids=["skip_absent", "one_fails", "at_the_floor", "empty", "all_fail"])
def test_check_floors_matches_jax(base, floors):
    want = _jax_tool("accuracy_gate").check_floors(base, floors)
    assert accuracy_gate.check_floors(base, floors) == want
    assert accuracy_gate.DEFAULT_FLOORS == _jax_tool("accuracy_gate").DEFAULT_FLOORS


# ---------------------------------------------- gate, oracle, load test

@pytest.fixture(scope="module")
def workspace(tiny_config, tmp_path_factory):
    """3 PNGs, their JAX fp32 detections as ground truth, a labels file
    and a JAX `save_params` checkpoint of nontrivial weights."""
    root = tmp_path_factory.mktemp("accuracy")
    _write_images(root / "images", SIZES[:3], seed=9, annotated=False)
    labels = root / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    ckpt = root / "model.msgpack"
    save_params(nontrivial_variables(tiny_config, seed=3), ckpt)
    with _cwd(root / "gt_run"):
        jax_detect_cli.main(["--valid_dir", str(root / "images"), "--conf_threshold", "0.2",
                             "--labels", str(labels), "--load_model", str(ckpt),
                             "--anchor_name", "stem", *MODEL, *DECODE, "--no_amp",
                             "--num_workers", "0"])
    return {"root": root, "labels": labels, "ckpt": ckpt,
            "gt": root / "gt_run" / "predictions", "images": root / "images"}


def _port_scores(ws):
    """Every fp32 anchor and part score of the port's decode at threshold 0."""
    from structuredetector_tpu_torch.config import config_from_args
    from structuredetector_tpu_torch.data import CropDataset, Loader, ValidationAugmentation
    from structuredetector_tpu_torch.ops.decode import split_head_output
    from structuredetector_tpu_torch.predictor import Predictor

    cfg = config_from_args(["--labels", str(ws["labels"]), "--load_model", str(ws["ckpt"]),
                            "--anchor_name", "stem", *MODEL, *DECODE, "--no_amp"])
    predictor = Predictor(cfg, device="cpu", device_normalize=False)
    batch = next(iter(Loader(CropDataset(cfg, ws["gt"], ValidationAugmentation(cfg)),
                             batch_size=8)))
    head = predictor.forward(predictor.to_device(batch["image"]))
    dec = predictor.decoder.decode_arrays(split_head_output(head, 2, 1), 0.0, 0.1)
    return torch.cat([dec["anchors"][..., 2].flatten(), dec["parts"][..., 2].flatten()])


def test_threshold_stands_clear_of_every_score(workspace):
    """No fp32 score within 1e-4 of CONF (the evaluate parity test's
    margin): an ulp of sigmoid between XLA and torch cannot flip a
    detection."""
    scores = _port_scores(workspace)
    assert float((scores - CONF).abs().min()) > 1e-4
    assert int((scores > CONF).sum()) > 0


def test_gate_matches_jax(workspace, tmp_path):
    """The gate in bf16: four finite arms, JAX's schema, modes and keys.
    Its checkpoint arm (`run_evaluate`, the `cli.evaluate` argv of the JAX
    gate) through the gate's own `--model_args` passthrough in fp32 equals
    JAX `cli.evaluate --save_summary` on the same checkpoint, flags and
    images, every value within 1e-6 (3 images at batch 2: a ragged last
    batch). bf16 is not compared across the frameworks: flax runs eval BN
    in bf16 and torch's autocast on f32 statistics, and a seeded net's
    smooth heatmaps quantize into plateaus whose ties then differ, so on
    each of 8 weight seeds tried the two bf16 decodes kept some other
    peak or label (anchor F1 0.716 against 0.758 on one)."""
    ws = workspace
    gate_argv = [str(ws["ckpt"]), "--valid_dir", str(ws["gt"]), "--train_dir", str(ws["images"]),
                 "--labels", str(ws["labels"]), "--anchor_name", "stem", "-W", "64", "-H", "64",
                 "--fpn_depth", "32", *DECODE, "--batch_size", "2", "--calibrate_images", "2",
                 "--conf_threshold", str(CONF), "--device", "cpu"]
    out = tmp_path / "gate.json"
    with _cwd(tmp_path):
        try:
            accuracy_gate.main(gate_argv + ["--out", str(out)])
        except SystemExit as e:  # floors fail on seeded weights; the JSON is written first
            assert e.code == 1
    payload = json.loads(out.read_text())
    fp32 = accuracy_gate.run_evaluate(
        ws["ckpt"], accuracy_gate.parse_args(gate_argv + ["--model_args=--no_amp"]),
        tmp_path / "fp32.json")
    jax_evaluate_cli.main([
        "--valid_dir", str(ws["gt"]), "--load_model", str(ws["ckpt"]),
        "--labels", str(ws["labels"]), "--anchor_name", "stem", *MODEL, *DECODE,
        "--conf_threshold", str(CONF), "--dist_threshold", "0.05",
        "--decoder_dist_thresh", "0.1", "--eval_batch_size", "2", "--no_amp",
        "--save_summary", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert set(fp32) == set(want)
    for key in want:
        assert abs(fp32[key] - want[key]) <= 1e-6, key
    assert want["anchor/f1_total"] > 0 and want["kps/f1_total"] > 0

    assert set(payload) == {"table", "summaries", "floors", "gate"}
    assert list(payload["summaries"]) == list(accuracy_gate.MODES)
    assert payload["floors"] == accuracy_gate.DEFAULT_FLOORS
    assert payload["gate"] == "PASS" or payload["gate"].startswith("FAIL: ")
    totals = {f"{f}/{m}_total" for f in accuracy_gate.FAMILIES
              for m in ("f1", "precision", "recall", "csi")}
    for mode, summary in payload["summaries"].items():
        # the per-bucket keys follow the detections; the totals are always there
        assert totals <= set(summary), mode
        assert all(math.isfinite(v) for v in summary.values()), mode
        assert f"| {mode} |" in payload["table"]
    header = ("| mode | " + " | ".join(f"{f} F1" for f in accuracy_gate.FAMILIES)
              + " | grouping | Δkps F1 |")
    assert payload["table"].splitlines()[0] == header
    assert payload["table"] == accuracy_gate.gate_table(payload["summaries"])


def test_oracle_arms_match_jax(workspace, tmp_path):
    ws = workspace
    argv = ["--arms", "ABD", "--valid_dir", str(ws["gt"]), "--labels", str(ws["labels"]),
            "--anchor_name", "stem", "--load_model", str(ws["ckpt"]), *MODEL, *DECODE,
            "--conf_threshold", str(CONF), "--no_amp"]
    want = _jax_tool("oracle_grouping").main(argv + ["--no_native_io"])
    got = oracle_grouping.main(argv + ["--device", "cpu", "--out", str(tmp_path / "o.json")])
    assert list(got) == list(want)
    for arm in ("A_gt_through_evaluator", "B_gt_encode_decode", "B_grouping_rate"):
        assert got[arm] == want[arm], arm
    assert got["A_gt_through_evaluator"]["anchor/f1_total"] == 1.0
    assert want["B_grouping_rate"]["total"] > 0
    for key, value in want["D_model_control"].items():
        assert abs(got["D_model_control"][key] - value) <= 1e-6, key
    assert got["D_grouping_rate"] == want["D_grouping_rate"]
    assert want["D_model_control"]["kps/f1_total"] > 0
    assert json.loads((tmp_path / "o.json").read_text()) == got


def test_dense_maps_from_gt_match_jax(workspace, tiny_config):
    """The oracle's GT maps: the port's NCHW maps are JAX's NHWC maps
    transposed (heatmap logits within 1e-4: XLA's and torch's exp differ
    in the last bits; the scattered maps equal)."""
    from structuredetector_tpu.data import CropDataset as JaxCropDataset
    from structuredetector_tpu.data import ValidationAugmentation as JaxValidationAugmentation
    from structuredetector_tpu_torch.data import CropDataset, ValidationAugmentation
    from tests.test_torch_port_model import port_config

    jax_oracle = _jax_tool("oracle_grouping")
    jax_cfg = tiny_config.__class__(**{**tiny_config.__dict__, "anchor_name": "stem",
                                       "native_io": False})
    cfg = port_config(tiny_config, anchor_name="stem")
    theirs = JaxCropDataset(jax_cfg, workspace["gt"], JaxValidationAugmentation(jax_cfg))
    ours = CropDataset(cfg, workspace["gt"], ValidationAugmentation(cfg))
    for i in range(len(ours)):
        want, _ = jax_oracle.dense_maps_from_gt(jax_cfg, theirs[i]["annotation"])
        got, _ = oracle_grouping.dense_maps_from_gt(cfg, ours[i]["annotation"])
        for key in ("offsets", "embeddings"):
            np.testing.assert_array_equal(got[key][0].permute(1, 2, 0).numpy(),
                                          np.asarray(want[key][0]))
        for key in ("anchor_hm", "part_hm"):
            np.testing.assert_allclose(got[key][0].permute(1, 2, 0).numpy(),
                                       np.asarray(want[key][0]), atol=1e-4)


def test_load_test_raises_when_the_server_dies(tmp_path):
    """A server that exits at startup (model flags beside --artifact) ends
    the test with its log, not after the health wait."""
    with pytest.raises(RuntimeError, match="(?s)exited with code 1.*unrecognized arguments"):
        load_test.main(["--artifact", str(tmp_path / "m.sdz"), "--device", "cpu", "--port", "0",
                        "--log_dir", str(tmp_path), "--", "--width", "64"])


# -------------------------------------------------------------- supervise

STUB = """
import json, sys
from pathlib import Path
calls = Path(sys.argv[1])
codes = json.loads(sys.argv[2])
n = len(calls.read_text().splitlines()) if calls.exists() else 0
with calls.open("a") as f:
    f.write(json.dumps(sys.argv[3:]) + "\\n")
if "--resume" not in sys.argv:
    run = Path("trainings") / f"run_{n}"
    (run / "state").mkdir(parents=True)
    (run / "state" / "step_000000000001.pt").write_bytes(b"")
sys.exit(codes[min(n, len(codes) - 1)])
"""


@pytest.mark.parametrize("codes,max_restarts,want_rc,want_calls", [
    ([87, 0], 5, 0, 2),
    ([87, 87, 0], 5, 0, 3),
    ([3], 5, 3, 1),
    ([87, 1], 5, 1, 2),
    ([87], 2, 87, 3),
], ids=["stall_then_done", "two_stalls", "other_code", "stall_then_error", "gives_up"])
def test_supervise_restarts_only_after_a_stall(tmp_path, codes, max_restarts, want_rc,
                                               want_calls):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    calls = tmp_path / "calls.txt"
    command = [sys.executable, str(stub), str(calls), json.dumps(codes)]
    rc, run_dir = supervise.supervise(["--epochs", "3"], max_restarts, cwd=tmp_path,
                                      command=command)
    assert rc == want_rc
    argvs = [json.loads(line) for line in calls.read_text().splitlines()]
    assert len(argvs) == want_calls
    assert run_dir == tmp_path / "trainings" / "run_0"
    assert argvs[0] == ["--epochs", "3"]
    for argv in argvs[1:]:
        assert argv == ["--epochs", "3", "--resume", str(run_dir)]


def test_supervise_starts_fresh_without_a_resumable_state(tmp_path):
    calls = []

    def fake_run(cmd, cwd, env, stdout, stderr):
        calls.append(cmd)
        (Path(cwd) / "trainings" / f"r{len(calls)}").mkdir(parents=True)
        return type("P", (), {"returncode": 87 if len(calls) == 1 else 0})()

    old = supervise.subprocess.run
    supervise.subprocess.run = fake_run
    try:
        rc, run_dir = supervise.supervise(["--x"], 5, cwd=tmp_path, command=["train"])
    finally:
        supervise.subprocess.run = old
    assert rc == 0 and calls == [["train", "--x"], ["train", "--x"]]
    assert run_dir == tmp_path / "trainings" / "r2"


# ------------------------------------------------------------- the chain

STUB_TRAIN = """
import shutil, sys
from pathlib import Path
run = Path("trainings") / "2026-01-01_00-00-00"
run.mkdir(parents=True)
shutil.copy(sys.argv[1], run / "model_best_csi.msgpack")
print("stub train", sys.argv[2:])
"""


def test_accuracy_run_end_to_end(workspace, tmp_path, monkeypatch):
    """The chain on the CPU with a stub trainer that writes the shared
    checkpoint as its best-CSI model: dataset, gate (one arm), oracle D, load test
    and sweep run and write their files under the JAX names with the
    `torch_` prefix; the flags after `--` reach the trainer last."""
    ws = workspace
    stub = tmp_path / "train.py"
    stub.write_text(STUB_TRAIN)
    monkeypatch.setattr(supervise, "TRAIN_COMMAND", [sys.executable, str(stub), str(ws["ckpt"])])
    # the four arms are test_gate_matches_jax's; here the chain's wiring,
    # through the checkpoint arm alone
    monkeypatch.setattr(accuracy_gate, "MODES", accuracy_gate.MODES[:1])
    out = tmp_path / "out"
    with _cwd(tmp_path / "work"):
        record = accuracy_run.run(accuracy_run.parse_args([
            "--data", str(tmp_path / "data"), "--train", "2", "--valid", "2", "--epochs", "1",
            "--device", "cpu", "--out", str(out), "--labels", str(ws["labels"]), *MODEL,
            "--oracle_arms", "D", "--sweep", "2", "--clients", "2", "--duration", "2",
            "--", "--batch_size", "2"]))
    assert (tmp_path / "data" / "train" / "im_0001.json").exists()
    assert record["dataset"] == "rendered"
    assert set(record["stages_s"]) == {"dataset", "train", "gate", "oracle", "load_test",
                                       "sweep"}
    for key in ("gate", "oracle", "load_test", "sweep", "record"):
        assert Path(record["results"][key]).exists(), key
    assert Path(record["results"]["gate"]).name == "torch_gate_r4_embw1.e1.json"
    log = (out / "torch_train_r4_embw1.e1.log").read_text()
    assert "--epochs', '1'" in log and "--hm_loss_fn', 'focal'" in log
    assert "--batch_size', '2'" in log  # the flags after -- come last and win
    gate = json.loads(Path(record["results"]["gate"]).read_text())
    sweep = json.loads(Path(record["results"]["sweep"]).read_text())
    assert set(sweep) == {"0.2", "0.25", "0.3", "0.4", "0.5"}
    assert gate["summaries"]["checkpoint_bf16"].keys() == sweep["0.4"].keys()
    assert "D_model_control" in json.loads(Path(record["results"]["oracle"]).read_text())
    # the load test against the port's cli.serve --device cpu: JAX's keys
    want_keys = json.loads((REPO / "_runs" / "load_test_r4b.json").read_text())["runs"][0]
    (run,) = json.loads(Path(record["results"]["load_test"]).read_text())["runs"]
    assert set(run) == set(want_keys)
    assert run["errors"] == 0 and run["requests"] > 0, run
    assert run["max_batch"] == 2 and run["server_mean_batch"] >= 1 and run["server_latency"]
    assert record["gate"] == gate["gate"]
