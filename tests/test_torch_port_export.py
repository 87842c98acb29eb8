"""The port's export slice against the JAX package, on the CPU.

Small config (64x64 input, 16x16 grid, `fpn_depth` 32, fp32, K=4
anchors, P=8 parts) and one JAX `save_params` checkpoint of nontrivial
weights, read by both packages. NHWC (JAX) and NCHW (port) outputs are
compared by transposing:

- the port's artifacts round-trip (static batch, dynamic batch, `--norm`,
  `--uint8_input`): the loaded program equals the live graph bit for bit,
  and its front equals the plain sigmoid + NMS ops;
- the port's artifact against the JAX artifact of the same checkpoint:
  every map within 1e-4 of its scale;
- the port's `evaluate_export`, the port's `evaluate` on the checkpoint
  and JAX `evaluate_export` give equal summaries, family by family
  (counters equal, every value within 1e-6);
- `ExportPredictor` on a ragged batch against a static artifact returns
  `Predictor`'s annotations;
- the named errors: a JAX artifact, an artifact traced for another
  device, uint8 without norm, calibration without int8, model flags
  beside `serve --artifact`.
"""

import dataclasses
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from structuredetector_tpu.cli import evaluate_export as jax_evaluate_export_cli
from structuredetector_tpu.export import export_model as jax_export_model
from structuredetector_tpu.export import load_exported as jax_load_exported
from structuredetector_tpu.models.network import save_params
from structuredetector_tpu_torch.cli import convert_export as convert_cli
from structuredetector_tpu_torch.cli import detect as detect_cli
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.cli import evaluate_export as evaluate_export_cli
from structuredetector_tpu_torch.cli.serve import main as serve_main
from structuredetector_tpu_torch.data.augment import ValidationAugmentation
from structuredetector_tpu_torch.data.dataset import CropDataset
from structuredetector_tpu_torch.data.decoders import ExportDecoder
from structuredetector_tpu_torch.data.pipeline import Loader
from structuredetector_tpu_torch.export import (
    FRAMEWORK,
    ArtifactDeviceError,
    JaxArtifactError,
    config_from_metadata,
    export_model,
    load_exported,
    make_export_fn,
)
from structuredetector_tpu_torch.models.network import build_model
from structuredetector_tpu_torch.models.weights import load_checkpoint
from structuredetector_tpu_torch.ops.decode import split_head_output
from structuredetector_tpu_torch.ops.tensor import clamped_sigmoid, plateau_nms
from structuredetector_tpu_torch.predictor import ExportPredictor, Predictor, PreparedImage
from tests.test_torch_port_evaluate import SIZES, _counters, _Recording, _write_images
from tests.test_torch_port_model import nontrivial_variables, port_config

M, N = 2, 1
# the keys of JAX export.py:123-138
JAX_KEYS = {"anchors", "parts", "scale_factor", "width", "height", "anchor_name",
            "batch_size", "dynamic_batch", "platforms", "normalized", "input_dtype", "int8",
            "framework", "version"}
DECODE = ["--max_objects", "4", "--max_parts", "8"]
CONF = 0.35


@pytest.fixture(scope="module")
def workspace(tiny_config, tmp_path_factory):
    """A JAX checkpoint, the port's config and weights from it, images,
    and their ground truth: the port's own fp32 detections."""
    root = tmp_path_factory.mktemp("export")
    variables = nontrivial_variables(tiny_config, seed=3)
    ckpt = root / "model.msgpack"
    save_params(variables, ckpt)
    labels = root / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    _write_images(root / "images", SIZES, seed=9, annotated=False)
    cfg = port_config(tiny_config, anchor_name="stem")
    return {"root": root, "variables": variables, "ckpt": ckpt, "labels": labels,
            "cfg": cfg, "weights": load_checkpoint(ckpt)}


@pytest.fixture(scope="module")
def ground_truth(workspace):
    import os

    root = workspace["root"]
    cwd = Path.cwd()
    os.chdir(root)
    try:
        detect_cli.main(["--device", "cpu", "--valid_dir", str(root / "images"),
                         "--conf_threshold", "0.2", *_model_flags(workspace)])
    finally:
        os.chdir(cwd)
    return root / "predictions"


def _model_flags(ws):
    return ["--labels", str(ws["labels"]), "--load_model", str(ws["ckpt"]), "--anchor_name",
            "stem", "--width", "64", "--height", "64", "--fpn_depth", "32", *DECODE,
            "--no_amp", "--num_workers", "2"]


@pytest.fixture(scope="module")
def static_artifact(workspace):
    """The port's fp32 artifact, static batch 2, host-normalized feed."""
    return export_model(workspace["cfg"], workspace["weights"],
                        workspace["root"] / "static.sdz", batch_size=2, device="cpu")


@pytest.fixture(scope="module")
def u8_artifact(workspace):
    """The port's uint8 artifact: normalization inside, any batch."""
    return export_model(workspace["cfg"], workspace["weights"], workspace["root"] / "u8.sdz",
                        batch_size=2, dynamic_batch=True, fold_normalization=True,
                        uint8_input=True, device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(workspace, tiny_config):
    return jax_export_model(tiny_config.__class__(**{**tiny_config.__dict__,
                                                      "anchor_name": "stem"}),
                            workspace["variables"], workspace["root"] / "jax.sdz",
                            batch_size=2)


def _images(seed, b, raw=False):
    rng = np.random.default_rng(seed)
    if raw:
        return rng.integers(0, 256, (b, 64, 64, 3)).astype(np.float32)
    return rng.normal(0, 1, (b, 64, 64, 3)).astype(np.float32)


# ------------------------------------------------------------ round trip

@pytest.mark.parametrize("flags", [
    dict(batch_size=2),
    dict(batch_size=1, dynamic_batch=True, fold_normalization=True),
    dict(batch_size=2, dynamic_batch=True, fold_normalization=True, uint8_input=True),
], ids=["static", "dynamic-norm", "dynamic-uint8"])
def test_port_round_trip(workspace, static_artifact, u8_artifact, tmp_path, flags):
    cfg = workspace["cfg"]
    path = {"float32": static_artifact, "uint8": u8_artifact}.get(
        "uint8" if flags.get("uint8_input") else "float32")
    if flags.get("dynamic_batch") and not flags.get("uint8_input"):
        path = export_model(cfg, workspace["weights"], tmp_path / "m.sdz", device="cpu", **flags)
    call, meta = load_exported(path, device="cpu")
    assert JAX_KEYS <= set(meta)
    assert meta["framework"] == FRAMEWORK and meta["platforms"] == ["cpu"]
    assert meta["normalized"] == flags.get("fold_normalization", False)
    assert meta["input_dtype"] == ("uint8" if flags.get("uint8_input") else "float32")
    assert (meta["dynamic_batch"], meta["batch_size"], meta["compute_dtype"]) == \
        (flags.get("dynamic_batch", False), flags["batch_size"], "float32")
    assert config_from_metadata(meta, anchor_name="other").anchor_name == "stem"

    model = build_model(cfg)
    model.load_state_dict(workspace["weights"])
    graph = make_export_fn(model, M, N, flags.get("fold_normalization", False))
    sizes = (3, 1) if flags.get("dynamic_batch") else (flags["batch_size"],)
    for b in sizes:
        x = _images(b, b, raw=flags.get("fold_normalization", False))
        got = call(x.astype(np.uint8) if flags.get("uint8_input") else x)
        with torch.inference_mode():
            want = graph(torch.from_numpy(x))
        assert got.shape == (b, M + N + 4, 16, 16) and got.dtype == torch.float32
        assert torch.equal(got, want)
    if not flags.get("dynamic_batch"):
        with pytest.raises(Exception):
            call(_images(0, 3))  # a static program takes its own batch only


def test_graph_front_equals_plain_ops(workspace):
    model = build_model(workspace["cfg"])
    model.load_state_dict(workspace["weights"])
    x = torch.from_numpy(_images(4, 2))
    with torch.inference_mode():
        got = make_export_fn(model, M, N)(x)
        raw = model.eval()(x.permute(0, 3, 1, 2).contiguous(), raw_output=True)
    assert torch.equal(got[:, : M + N], plateau_nms(clamped_sigmoid(raw[:, : M + N])))
    assert torch.equal(got[:, M + N :], raw[:, M + N :])
    heat = got[:, : M + N]
    assert float(heat.min()) >= 0.0 and float(heat.max()) <= 1.0
    assert float((heat == 0).float().mean()) > 0.5  # NMS zeroed the non-peaks


def test_port_artifact_matches_jax_artifact(static_artifact, jax_artifact):
    x = _images(6, 2)
    jax_call, jax_meta = jax_load_exported(jax_artifact)
    want = np.transpose(np.asarray(jax_call(x)), (0, 3, 1, 2))
    call, meta = load_exported(static_artifact, device="cpu")
    got = call(x).numpy()
    assert set(jax_meta) <= set(meta)
    for key in JAX_KEYS - {"framework", "platforms"}:
        assert meta[key] == jax_meta[key], key
    for name, ch in (("heatmaps", slice(0, M + N)), ("offsets", slice(M + N, M + N + 2)),
                     ("embeddings", slice(M + N + 2, None))):
        scale = float(np.abs(want[:, ch]).max())
        np.testing.assert_allclose(got[:, ch], want[:, ch], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


# ------------------------------------------------------------ the CLIs

def _summary(path: Path) -> dict:
    return json.loads(path.read_text())


def test_evaluate_export_matches_evaluate_and_jax(workspace, ground_truth, static_artifact,
                                                  jax_artifact, tmp_path, monkeypatch):
    """Five images against a static batch of 2: the last batch is ragged
    and padded in both packages."""
    from structuredetector_tpu.evaluation import Evaluator as JaxEvaluator

    common = ["--valid_dir", str(ground_truth), "--anchor_name", "stem", *DECODE,
              "--conf_threshold", str(CONF)]
    ours = evaluate_export_cli.main([str(static_artifact), "--device", "cpu", *common,
                                     "--save_summary", str(tmp_path / "export.json")])
    live = evaluate_cli.main(["--device", "cpu", "--valid_dir", str(ground_truth),
                              "--eval_batch_size", "2", "--conf_threshold", str(CONF),
                              "--save_summary", str(tmp_path / "live.json"),
                              *_model_flags(workspace)])[CONF]
    recorder = _Recording(JaxEvaluator)
    monkeypatch.setattr(jax_evaluate_export_cli, "Evaluator", recorder)
    jax_evaluate_export_cli.main([str(jax_artifact), *common,
                                  "--save_summary", str(tmp_path / "jax.json")])

    # the threshold stands clear of every score the artifact gives, so an
    # ulp between XLA and torch cannot flip a detection
    cfg = workspace["cfg"]
    batch = next(iter(Loader(CropDataset(cfg, ground_truth, ValidationAugmentation(cfg)),
                             batch_size=len(SIZES))))
    images = np.concatenate([batch["image"], np.zeros_like(batch["image"][:1])])
    call, _ = load_exported(static_artifact, device="cpu")
    dec = [ExportDecoder(cfg).decode_arrays(split_head_output(call(images[i:i + 2]), M, N),
                                            0.0, cfg.decoder_dist_thresh)
           for i in range(0, len(images), 2)]
    scores = torch.cat([d[k][..., 2].flatten() for d in dec for k in ("anchors", "parts")])
    assert float((scores - CONF).abs().min()) > 1e-4

    assert _counters(ours) == _counters(live) == _counters(recorder.made[0])
    assert sum(e.tp for _, e in ours.anchor_eval.items()) > 0
    # values within 1e-6: the padded last batch of the static program
    # changes the CPU convolution's summation order against the live
    # batch of 1, so distances move at float32 round-off
    got = _summary(tmp_path / "export.json")
    for other in ("live.json", "jax.json"):
        want = _summary(tmp_path / other)
        assert set(got) == set(want)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6, (other, key)
    assert {key.split("/")[0] for key in got} >= {"anchor", "part", "csi", "classif"}


def test_export_predictor_on_a_ragged_batch_matches_predictor(workspace, static_artifact,
                                                              u8_artifact):
    from PIL import Image

    cfg = dataclasses.replace(workspace["cfg"], conf_threshold=0.3,
                              pretrained_model=workspace["ckpt"])
    images = [Image.open(p) for p in sorted((workspace["root"] / "images").glob("*.png"))[:3]]
    live = Predictor(cfg, device="cpu", device_normalize=False)
    ours = ExportPredictor(static_artifact, device="cpu", max_objects=4, max_parts=8,
                           conf_threshold=0.3)
    assert ours.batch_size == 2 and not ours.feed_uint8 and ours.feed_normalize
    want = [a.json_repr() for a in live.predict_batch(images)]
    assert sum(len(a["objects"]) for a in want) > 0
    assert [a.json_repr() for a in ours.predict_batch(images)] == want  # chunks 2 + 1
    handle = ours.predict_batch_submit(images[:1])
    assert [a.json_repr() for a in ours.predict_batch_collect(handle)] == want[:1]
    assert ours.predict_batch([]) == []

    # a uint8 artifact with the normalization inside, any batch, against
    # the predictor that normalizes on its device; PreparedImage feeds
    ours = ExportPredictor(u8_artifact, device="cpu", max_objects=4, max_parts=8,
                           conf_threshold=0.3)
    live = Predictor(cfg, device="cpu", device_normalize=True)
    assert ours.batch_size is None and ours.feed_uint8 and not ours.feed_normalize
    want = [a.json_repr() for a in live.predict_batch(images)]
    assert [a.json_repr() for a in ours.predict_batch(images)] == want
    prepared = [PreparedImage(live.transform(im.convert("RGB")), im.size) for im in images]
    got = [a.json_repr() for a in ours.predict_batch(prepared)]
    assert [(a["img_size"], a["objects"]) for a in got] == \
        [(a["img_size"], a["objects"]) for a in want]
    head = ours.forward(ours.to_device([p.array for p in prepared]))
    assert head.shape == (3, M + N + 4, 16, 16)
    assert set(ours.decode(head)) >= {"anchors", "parts", "part_parent", "part_valid"}


def test_convert_export_cli(workspace, tmp_path):
    out = convert_cli.main([str(workspace["ckpt"]), "-o", str(tmp_path / "cli.sdz"),
                            "--params", str(workspace["labels"]), "--width", "64",
                            "--height", "64", "--fpn-depth", "32", "--anchor_name", "stem",
                            "--uint8_input", "--dynamic_batch", "--device", "cpu"])
    call, meta = load_exported(out, device="cpu")
    assert (meta["normalized"], meta["input_dtype"], meta["dynamic_batch"]) == \
        (True, "uint8", True)
    assert meta["compute_dtype"] == "bfloat16" and meta["int8"] is False  # the config default
    head = call(np.zeros((3, 64, 64, 3), np.uint8))
    assert head.shape == (3, M + N + 4, 16, 16) and bool(torch.isfinite(head).all())


# ------------------------------------------------------------ named errors

def test_named_errors(workspace, static_artifact, jax_artifact, tmp_path):
    with pytest.raises(JaxArtifactError, match="model.stablehlo"):
        load_exported(jax_artifact, device="cpu")
    with pytest.raises(JaxArtifactError):
        ExportPredictor(jax_artifact, device="cpu")

    # an artifact traced for the card refuses the CPU instead of moving there
    moved = tmp_path / "cuda.sdz"
    with zipfile.ZipFile(static_artifact) as src, zipfile.ZipFile(moved, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "params.json":
                data = json.dumps({**json.loads(data), "platforms": ["cuda"]})
            dst.writestr(name, data)
    with pytest.raises(ArtifactDeviceError, match=r"traced for \['cuda'\]"):
        load_exported(moved, device="cpu")

    with pytest.raises(ValueError, match="uint8_input requires fold_normalization"):
        export_model(workspace["cfg"], workspace["weights"], tmp_path / "x.sdz",
                     uint8_input=True, device="cpu")
    flags = [str(workspace["ckpt"]), "-o", str(tmp_path / "y.sdz"), "--params",
             str(workspace["labels"]), "--width", "64", "--height", "64", "--fpn-depth", "32",
             "--device", "cpu"]
    with pytest.raises(SystemExit, match="--calibrate_dir requires --int8"):
        convert_cli.main([*flags, "--calibrate_dir", str(workspace["root"] / "images")])
    assert not (tmp_path / "y.sdz").exists()
    with pytest.raises(ValueError, match="fpn_depth: 32 in the .*, 16 in the model"):
        convert_cli.main([*flags[:-3], "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unrecognized arguments with --artifact"):
        serve_main(["--artifact", str(static_artifact), "--device", "cpu",
                    "--fpn_depth", "32"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportPredictor(static_artifact)  # the default device is the card
