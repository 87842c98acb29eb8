"""The port's evaluate/detect slice against the JAX package, on the CPU.

Small config (64x64 input, 16x16 grid, `fpn_depth` 32, fp32, K=4
anchors, P=8 parts). Inputs come from numpy seeds and go through both
packages:

- the `Decoder`'s metadata path and `KeypointDecoder` on the same logits:
  rows at atol 1e-5 (XLA's and torch's CPU sigmoids may differ by an
  ulp), `raw_parts` equal in kind and count, coordinates within 1e-4 px;
- the `Evaluator` copy on the same scenes: counters equal, every
  `scalar_summary` value within 1e-9;
- the dataset, loader, visualization and annotation helpers on the
  same files: equal;
- the `evaluate` and `detect` CLIs on one `.msgpack` checkpoint written
  by JAX `save_params`: summaries family by family (tp/npos/ndet equal,
  F1 within 1e-6) and prediction JSONs (coordinates within 1e-3 px,
  scores within 1e-5), plain and `--tiled`.

The JAX Decoder runs as on any CPU: its plain XLA front (no Pallas).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from structuredetector_tpu import annotations as jax_annotations
from structuredetector_tpu.cli import detect as jax_detect_cli
from structuredetector_tpu.cli import evaluate as jax_evaluate_cli
from structuredetector_tpu.data.augment import ValidationAugmentation as JaxValidationAugmentation
from structuredetector_tpu.data.dataset import CropDataset as JaxCropDataset
from structuredetector_tpu.data.decoders import Decoder as JaxDecoder
from structuredetector_tpu.data.decoders import KeypointDecoder as JaxKeypointDecoder
from structuredetector_tpu.evaluation import Evaluator as JaxEvaluator
from structuredetector_tpu.models.network import save_params
from structuredetector_tpu.visualization import draw as jax_draw
from structuredetector_tpu_torch import annotations
from structuredetector_tpu_torch.cli import detect as detect_cli
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.config import config_from_args
from structuredetector_tpu_torch.data.augment import ValidationAugmentation
from structuredetector_tpu_torch.data.dataset import CropDataset, DatasetStats, PredictionDataset
from structuredetector_tpu_torch.data.decoders import Decoder, KeypointDecoder
from structuredetector_tpu_torch.data.pipeline import Loader
from structuredetector_tpu_torch.evaluation import Evaluator
from structuredetector_tpu_torch.ops.decode import split_head_output
from structuredetector_tpu_torch.tools import bench_topk_variants
from structuredetector_tpu_torch.visualization import draw
from tests.test_torch_port_model import nontrivial_variables, port_config

M, N = 2, 1
FAMILIES = ("anchor_eval", "part_eval", "csi_eval", "classification_eval")


# ---------------------------------------------------------------- decoder

def _jax_outputs(head: np.ndarray):
    nhwc = jnp.asarray(np.transpose(head, (0, 2, 3, 1)))
    nb = M + N
    return {"anchor_hm": nhwc[..., :M], "part_hm": nhwc[..., M:nb],
            "offsets": nhwc[..., nb : nb + 2], "embeddings": nhwc[..., nb + 2 : nb + 4]}


def _port_outputs(head: np.ndarray):
    return split_head_output(torch.from_numpy(head), M, N)


@pytest.fixture(scope="module")
def head():
    """(B, M+N+4, 16, 16) logits whose regressed maps link parts often."""
    rng = np.random.default_rng(23)
    raw = rng.normal(0, 2, (3, M + N + 4, 16, 16)).astype(np.float32)
    raw[:, M + N :] = rng.uniform(-1.5, 1.5, raw[:, M + N :].shape)
    return raw


def _kp_rows(kps):
    return [(kp.kind, kp.x, kp.y, kp.score) for kp in kps]


def _assert_kps_close(got, want, atol_xy=1e-4):
    got, want = _kp_rows(got), _kp_rows(want)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1:3] for g in got], [w[1:3] for w in want], atol=atol_xy)
    np.testing.assert_allclose([g[3] for g in got], [w[3] for w in want], atol=1e-5)


def _assert_annotations_close(got, want):
    assert len(got.objects) == len(want.objects)
    for g, w in zip(got.objects, want.objects):
        assert g.name == w.name
        _assert_kps_close([g.anchor, *g.parts], [w.anchor, *w.parts])


@pytest.mark.parametrize("conf", [0.3, 0.6])
def test_decoder_metadata_matches_jax(tiny_config, head, conf):
    cfg = port_config(tiny_config)
    want = JaxDecoder(tiny_config)(_jax_outputs(head), conf_thresh=conf, dist_thresh=0.3,
                                   return_metadata=True)
    got = Decoder(cfg)(_port_outputs(head), conf_thresh=conf, dist_thresh=0.3,
                       return_metadata=True)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["anchors"], np.asarray(want["anchors"]), atol=1e-5)
    np.testing.assert_allclose(got["parts"], np.asarray(want["parts"]), atol=1e-5)
    for key in ("anchor_hm_sig", "part_hm_sig"):
        np.testing.assert_allclose(np.transpose(got[key].numpy(), (0, 2, 3, 1)),
                                   np.asarray(want[key]), atol=1e-6)
    np.testing.assert_allclose(got["embeddings"].numpy(), np.asarray(want["embeddings"]),
                               atol=1e-6)
    for key in ("raw_embeddings", "raw_offsets"):
        np.testing.assert_array_equal(np.transpose(got[key].numpy(), (0, 2, 3, 1)),
                                      np.asarray(want[key]))
    assert any(want["raw_parts"]), "no raw part above conf: the case tests nothing"
    for g, w in zip(got["raw_parts"], want["raw_parts"]):
        _assert_kps_close(g, w)
    assert sum(len(a.objects) for a in want["annotation"]) > 0
    for g, w in zip(got["annotation"], want["annotation"]):
        _assert_annotations_close(g, w)


def test_score_at_conf_is_a_raw_part_and_no_anchor(tiny_config):
    """A logit of 0 scores exactly 0.5 in both packages. At conf 0.5 the
    anchor is dropped (its test is score > conf) and the part is kept in
    raw_parts (its test is score >= conf, the strict `< conf` skip)."""
    head = np.full((1, M + N + 4, 16, 16), -6.0, np.float32)
    head[:, M + N :] = 0.0
    head[0, 0, 5, 5] = 0.0  # an anchor peak of score 0.5
    head[0, M, 9, 9] = 0.0  # a part peak of score 0.5
    want = JaxDecoder(tiny_config)(_jax_outputs(head), conf_thresh=0.5, return_metadata=True)
    got = Decoder(port_config(tiny_config))(_port_outputs(head), conf_thresh=0.5,
                                            return_metadata=True)
    for data in (got, want):
        assert data["annotation"][0].objects == []
        assert [(kp.kind, kp.x, kp.y, kp.score) for kp in data["raw_parts"][0]] == \
            [("leaf", 36.0, 36.0, 0.5)]


def test_keypoint_decoder_matches_jax(tiny_config, head):
    want = JaxKeypointDecoder(tiny_config)(_jax_outputs(head))
    got = KeypointDecoder(port_config(tiny_config))(_port_outputs(head))
    assert len(got) == len(want) == head.shape[0]
    assert sum(map(len, want)) > 0
    for g, w in zip(got, want):
        _assert_kps_close(g, w)


# -------------------------------------------------------------- evaluator

def _scene_json(rng, i: int, jitter: float):
    """An annotation dict of 0-4 objects; with `jitter`, a prediction of
    it: moved points, random scores, some objects dropped or added."""
    w, h = int(rng.integers(60, 200)), int(rng.integers(60, 200))
    objects = []
    for _ in range(int(rng.integers(0, 5))):
        ax, ay = rng.uniform(0, w), rng.uniform(0, h)
        n_parts = int(rng.integers(0, 4))
        parts = [{"kind": "stem", "location": {"x": ax, "y": ay}, "score": None}]
        parts += [{"kind": "leaf", "location": {"x": ax + rng.normal(0, 8),
                                                 "y": ay + rng.normal(0, 8)},
                   "score": None} for _ in range(n_parts)]
        objects.append({"label": str(rng.choice(["bean", "maize"])), "box": None,
                        "parts": parts})
    if jitter:
        objects = [o for o in objects if rng.random() > 0.2]
        for o in objects:
            for p in o["parts"]:
                p["location"]["x"] += rng.normal(0, jitter)
                p["location"]["y"] += rng.normal(0, jitter)
                p["score"] = float(rng.uniform(0.3, 1.0))
    return {"image_path": f"img_{i}.png", "img_size": [w, h], "objects": objects}


def _load(module, data: dict, path: Path):
    path.write_text(json.dumps(data))
    return module.ImageAnnotation.from_json(path, "stem")


def _counters(evaluator):
    return {fam: {label: (e.tp, e.npos, e.ndet) for label, e in getattr(evaluator, fam).items()}
            for fam in FAMILIES}


def test_evaluator_copy_matches_jax(tiny_config, tmp_path):
    rng = np.random.default_rng(41)
    cfg = port_config(tiny_config, dist_threshold=0.1)
    jax_cfg = tiny_config.__class__(**{**tiny_config.__dict__, "dist_threshold": 0.1})
    ours, theirs = Evaluator(cfg), JaxEvaluator(jax_cfg)
    for i in range(12):
        gt = _scene_json(rng, i, 0)
        pred = _scene_json(np.random.default_rng(100 + i), i, 0)
        if i % 3:  # most predictions: the ground truth moved a little
            pred = json.loads(json.dumps(gt))
            pred = {**pred, "objects": [o for o in pred["objects"] if rng.random() > 0.2]}
            for o in pred["objects"]:
                for p in o["parts"]:
                    p["location"]["x"] += rng.normal(0, 3)
                    p["location"]["y"] += rng.normal(0, 3)
                    p["score"] = float(rng.uniform(0.3, 1.0))
        for module, ev in ((annotations, ours), (jax_annotations, theirs)):
            g = _load(module, gt, tmp_path / "gt.json")
            p = _load(module, pred, tmp_path / "pred.json")
            # the evaluator compares in net-input space: scale both there
            size = (cfg.width, cfg.height)
            g.resize(g.img_size, size)
            p.resize(p.img_size, size)
            raw = [kp for o in p.objects for kp in o.parts]
            ev.accumulate(p, g, raw, eval_csi=True, eval_classif=True)
    assert _counters(ours) == _counters(theirs)
    assert sum(e.tp for _, e in ours.anchor_eval.items()) > 0
    a, b = ours.scalar_summary(), theirs.scalar_summary()
    assert set(a) == set(b)
    for key in b:
        assert abs(a[key] - b[key]) <= 1e-9, key
    assert a["anchor/f1_total"] > 0
    assert ours._csv_kps_str() == theirs._csv_kps_str()
    assert repr(ours) == repr(theirs)


# ------------------------------------------------- data, drawing, helpers

def _write_images(root: Path, sizes, seed: int, annotated: bool):
    """PNG images of the given sizes (lossless, so both packages see the
    same pixels); with `annotated`, a JSON beside each (anchor "stem")."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i, (w, h) in enumerate(sizes):
        img = Image.new("RGB", (w, h), (40, 120, 40))
        d = ImageDraw.Draw(img)
        objs = []
        for _ in range(int(rng.integers(1, 4))):
            ax, ay = int(rng.integers(4, w - 4)), int(rng.integers(4, h - 4))
            d.ellipse([ax - 4, ay - 4, ax + 4, ay + 4], fill=(200, 60, 60))
            px, py = ax + 8, ay + 6  # may fall outside: the loader clips it
            parts = [{"kind": "stem", "location": {"x": ax, "y": ay}, "score": None},
                     {"kind": "leaf", "location": {"x": px, "y": py}, "score": None}]
            objs.append({"label": str(rng.choice(["bean", "maize"])), "box": None,
                         "parts": parts})
        img.save(root / f"im_{i}.png")
        if annotated:
            (root / f"im_{i}.json").write_text(json.dumps({
                "image_path": str(root / f"im_{i}.png"), "img_size": [w, h],
                "objects": objs}))


SIZES = [(80, 64), (100, 90), (64, 64), (70, 120), (130, 70)]


@pytest.fixture(scope="module")
def annotated_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("valid")
    _write_images(root, SIZES, seed=5, annotated=True)
    return root


def test_dataset_and_loader_match_jax(tiny_config, annotated_dir):
    cfg = port_config(tiny_config, anchor_name="stem")
    jax_cfg = tiny_config.__class__(**{**tiny_config.__dict__, "anchor_name": "stem",
                                       "native_io": False})
    ours = CropDataset(cfg, annotated_dir, ValidationAugmentation(cfg))
    theirs = JaxCropDataset(jax_cfg, annotated_dir, JaxValidationAugmentation(jax_cfg))
    assert len(ours) == len(theirs) == len(SIZES)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["annotation"].json_repr() == b["annotation"].json_repr()
    batches = list(Loader(ours, batch_size=2, num_workers=3))
    serial = list(Loader(ours, batch_size=2, num_workers=0))
    assert [b["image"].shape[0] for b in batches] == [2, 2, 1]
    for a, b in zip(batches, serial):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert [x.json_repr() for x in a["annotation"]] == \
            [x.json_repr() for x in b["annotation"]]
    np.testing.assert_array_equal(batches[1]["image"][0], ours[2]["image"])
    stats = ours.stats()
    assert isinstance(stats, DatasetStats)
    assert sum(s.count for _, s in stats.items()) == sum(
        len(a.objects) for a in (ours[i]["annotation"] for i in range(len(ours))))
    assert str(stats) == str(theirs.stats())


def test_draw_matches_jax(tiny_config, annotated_dir):
    cfg = port_config(tiny_config, anchor_name="stem")
    path = annotated_dir / "im_1.json"
    ours = annotations.ImageAnnotation.from_json(path, "stem")
    theirs = jax_annotations.ImageAnnotation.from_json(path, "stem")
    image = Image.open(ours.image_path).convert("RGB")
    np.testing.assert_array_equal(np.asarray(draw(image, ours, cfg)),
                                  np.asarray(jax_draw(image, theirs, tiny_config)))
    assert cfg.label_color_map == tiny_config.label_color_map
    assert cfg.part_color_map == tiny_config.part_color_map


def test_debug_drawings_match_jax(tiny_config, head):
    """The heatmap composite, the raw top-k rays and the embedding quiver
    of one image, from the same arrays through both packages."""
    from structuredetector_tpu import visualization as jax_vis
    from structuredetector_tpu_torch import visualization as vis

    cfg = port_config(tiny_config)
    dec = JaxDecoder(tiny_config)(_jax_outputs(head), conf_thresh=0.3, return_metadata=True)
    image = np.random.default_rng(4).normal(0, 1, (64, 64, 3)).astype(np.float32)
    hm = [np.asarray(dec[k][0]) for k in ("anchor_hm_sig", "part_hm_sig")]
    for got, want in zip(vis.draw_heatmaps(*hm, cfg), jax_vis.draw_heatmaps(*hm, tiny_config)):
        np.testing.assert_array_equal(got, want)
    rows = (dec["anchors"][0], dec["parts"][0])
    np.testing.assert_array_equal(np.asarray(vis.draw_kp_and_emb(image, *rows, cfg)),
                                  np.asarray(jax_vis.draw_kp_and_emb(image, *rows, tiny_config)))
    emb = np.transpose(head[0, M + N + 2 :], (1, 2, 0))
    np.testing.assert_array_equal(np.asarray(vis.draw_embeddings(image, emb, cfg)),
                                  np.asarray(jax_vis.draw_embeddings(image, emb, tiny_config)))


def test_annotation_helpers_match_jax(annotated_dir):
    assert sorted(annotations.files_with_extension(annotated_dir, ".json")) == \
        sorted(jax_annotations.files_with_extension(annotated_dir, ".json"))
    words = ["bean", "maize", "beet", "mint", "bark"]
    assert annotations.dict_grouping(words, lambda s: s[0]) == \
        jax_annotations.dict_grouping(words, lambda s: s[0])
    path = annotated_dir / "im_0.json"
    a = annotations.clip_annotation(annotations.ImageAnnotation.from_json(path, "stem"),
                                    (50, 40))
    b = jax_annotations.clip_annotation(
        jax_annotations.ImageAnnotation.from_json(path, "stem"), (50, 40))
    assert a.json_repr() == b.json_repr()
    names = [f"label_{i}" * (i + 1) for i in range(12)]  # 7..84 bytes: every xxh64 branch
    assert annotations.get_unique_color_map(names) == jax_annotations.get_unique_color_map(names)
    assert len(PredictionDataset(annotated_dir)) == len(SIZES)


def test_config_evaluate_flags():
    cfg = config_from_args(["--labels", "labels.json", "--conf_sweep", "0.1,0.3,0.5",
                            "--save_summary", "s.json", "--eval_batch_size", "0",
                            "--tiled", "--tile_overlap", "0.4", "--no_native_io"])
    assert cfg.conf_sweep == (0.1, 0.3, 0.5)
    assert cfg.summary_path == Path("s.json")
    assert cfg.eval_batch_size == 1  # clamped, as the JAX parser does
    assert cfg.tiled and cfg.tile_overlap == 0.4
    with pytest.raises(ValueError, match="conf_sweep"):
        config_from_args(["--labels", "labels.json", "--conf_sweep", "0.2,1.5"])


def test_variant_shootout_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench_topk_variants.main([])


# --------------------------------------------------------------- the CLIs

COMMON = ["--anchor_name", "stem", "--width", "64", "--height", "64",
          "--fpn_depth", "32", "--max_objects", "4", "--max_parts", "8", "--no_amp",
          "--num_workers", "2"]
# Away from every score the model gives these images (the test asserts
# it): an ulp of sigmoid between XLA and torch cannot flip a detection.
SWEEP = (0.35, 0.6)


@pytest.fixture(scope="module")
def cli_workspace(tiny_config, tmp_path_factory):
    """Unlabeled images, a labels file and a JAX `save_params` checkpoint
    of nontrivial weights."""
    root = tmp_path_factory.mktemp("cli")
    _write_images(root / "images", SIZES, seed=9, annotated=False)
    labels = root / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    ckpt = root / "model.msgpack"
    save_params(nontrivial_variables(tiny_config, seed=3), ckpt)
    args = ["--labels", str(labels), "--load_model", str(ckpt), *COMMON]
    return root, args


def _predictions(directory: Path):
    return {p.name: json.loads(p.read_text()) for p in sorted(directory.glob("*.json"))}


def _assert_predictions_close(got: dict, want: dict):
    assert list(got) == list(want)
    n_objects = 0
    for name in want:
        g, w = got[name], want[name]
        assert (g["image_path"], g["img_size"]) == (w["image_path"], w["img_size"])
        assert len(g["objects"]) == len(w["objects"]), name
        for og, ow in zip(g["objects"], w["objects"]):
            assert og["label"] == ow["label"]
            assert [p["kind"] for p in og["parts"]] == [p["kind"] for p in ow["parts"]]
            for pg, pw in zip(og["parts"], ow["parts"]):
                np.testing.assert_allclose(
                    (pg["location"]["x"], pg["location"]["y"]),
                    (pw["location"]["x"], pw["location"]["y"]), atol=1e-3)
                assert abs(pg["score"] - pw["score"]) <= 1e-5
            n_objects += 1
    assert n_objects > 0, "no detections: the comparison tests nothing"


def _run_detect(main, monkeypatch, cwd: Path, argv):
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    main(argv)
    return cwd / "predictions"


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled"])
def test_detect_cli_matches_jax(cli_workspace, monkeypatch, tiled):
    root, args = cli_workspace
    argv = ["--valid_dir", str(root / "images"), "--conf_threshold", "0.3",
            "--eval_batch_size", "2", *args] + (["--tiled"] if tiled else [])
    tag = "tiled" if tiled else "plain"
    want = _run_detect(jax_detect_cli.main, monkeypatch, root / f"jax_{tag}", argv)
    got = _run_detect(detect_cli.main, monkeypatch, root / f"port_{tag}",
                      ["--device", "cpu", *argv])
    _assert_predictions_close(_predictions(got), _predictions(want))
    overlays = sorted(p.name for p in got.glob("*.png"))
    assert overlays == sorted(p.name for p in (root / "images").glob("*.png"))


class _Recording:
    """Wraps an Evaluator class so a test can read the counters of every
    instance a CLI made."""

    def __init__(self, cls):
        self.cls, self.made = cls, []

    def __call__(self, config):
        ev = self.cls(config)
        self.made.append(ev)
        return ev


def test_evaluate_cli_matches_jax(cli_workspace, monkeypatch, tmp_path):
    root, args = cli_workspace
    # ground truth: the JAX model's own detections, so the counters hold
    # true positives
    gt = _run_detect(jax_detect_cli.main, monkeypatch, root / "gt",
                     ["--valid_dir", str(root / "images"), "--conf_threshold", "0.2", *args])
    sweep = ",".join(map(str, SWEEP))
    argv = ["--valid_dir", str(gt), "--eval_batch_size", "2", "--conf_sweep", sweep,
            "--save_csv_eval", str(tmp_path / "kps.csv"), *args]

    recorder = _Recording(JaxEvaluator)
    monkeypatch.setattr(jax_evaluate_cli, "Evaluator", recorder)
    jax_evaluate_cli.main([*argv, "--no_native_io", "--save_summary",
                           str(tmp_path / "jax.json")])
    evaluators = evaluate_cli.main(["--device", "cpu", *argv, "--save_summary",
                                    str(tmp_path / "port.json")])

    # the thresholds stand clear of every score the model gives
    cfg = config_from_args(argv)
    from structuredetector_tpu_torch.predictor import Predictor

    predictor = Predictor(cfg, device="cpu", device_normalize=False)
    dataset = CropDataset(cfg, gt, ValidationAugmentation(cfg))
    batch = next(iter(Loader(dataset, batch_size=len(dataset))))
    with torch.inference_mode():
        head = predictor.forward(predictor.to_device(batch["image"]))
        dec = predictor.decoder.decode_arrays(
            split_head_output(head, M, N), 0.0, cfg.decoder_dist_thresh)
    scores = torch.cat([dec["anchors"][..., 2].flatten(), dec["parts"][..., 2].flatten()])
    assert min(float((scores - t).abs().min()) for t in SWEEP) > 1e-4

    theirs = dict(zip(SWEEP, recorder.made))
    assert set(evaluators) == set(theirs)
    for t in SWEEP:
        assert _counters(evaluators[t]) == _counters(theirs[t]), t
    assert sum(e.tp for _, e in evaluators[SWEEP[0]].anchor_eval.items()) > 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want) == {f"{t:g}" for t in SWEEP}
    for t in want:
        assert set(got[t]) == set(want[t])
        for key in want[t]:
            assert abs(got[t][key] - want[t][key]) <= 1e-6, (t, key)
    assert want[f"{SWEEP[0]:g}"]["anchor/f1_total"] > 0
    assert (tmp_path / "kps.csv").read_text()

    # one threshold without the sweep: the sweep's first summary
    evaluate_cli.main(["--device", "cpu", "--valid_dir", str(gt), "--eval_batch_size", "2",
                       "--conf_threshold", str(SWEEP[0]),
                       "--save_summary", str(tmp_path / "one.json"), *args])
    assert json.loads((tmp_path / "one.json").read_text()) == got[f"{SWEEP[0]:g}"]


def test_clis_raise_without_cuda_unless_asked(cli_workspace):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    root, args = cli_workspace
    for main in (evaluate_cli.main, detect_cli.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--valid_dir", str(root / "images"), *args])
