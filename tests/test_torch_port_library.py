"""The last modules of the port against the JAX package on the CPU, each
held to its JAX function on the same numpy-seeded inputs:

- `data/augment.py::RandomResize` (the same seeded rng: the same sizes,
  pixels and annotations; JAX tests/test_augment.py:227);
- `visualization.py::draw_keypoints` (byte-equal images at two sizes,
  an unknown kind raises; JAX tests/test_visualization.py:85);
- `CropDataset.part_count_histogram` and `histogram` (JAX
  tests/test_parity_extras.py:92);
- `utils.py::AverageMeter`, `set_seed`, `mkdir_if_needed` (JAX
  tests/test_parity_extras.py:230; the port's `set_seed` returns a
  `torch.Generator` where JAX's returns a PRNG key);
- `CropDataset` over a list of directories and with a list transform,
  `PredictionDataset(directory, transform)` and the `Loader`'s
  `collate_fn` and `prefetch_batches` (JAX tests/test_augment.py:193,
  :216 and `data/pipeline.py`);
- `ops/tensor.py::clamp_in_0_1` (and `clamped_sigmoid` through it, bit
  for bit the formula the kernels' plain versions used);
- the reference `.pth` writer (`models/weights.py::save_reference_pth`):
  on the same weights, carried across by `state_dict_from_jax`, the
  port's file and JAX `models/torch_export.py`'s load to equal
  state_dicts (`torch.save` output is not byte-stable), and both refuse
  `--head_conv`, resnet18 and resnet50 with the same reasons (JAX
  tests/test_torch_export.py:39,105);
- `models.ResNetEncoder` against JAX `ResNet34Encoder` on the same
  weights;
- the package API: every public top-level name of JAX `__init__.py` and
  of its `data`, `ops`, `models` and `train` resolves in the port, under
  its own name or the mapped one, and importing the package loads no
  JAX, no `ops/kernels/_build.py`, no `parallel/` and no server.
"""

import importlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import structuredetector_tpu as jax_package
from structuredetector_tpu import utils as jax_utils
from structuredetector_tpu import visualization as jax_visualization
from structuredetector_tpu.annotations import ImageAnnotation as JaxImageAnnotation
from structuredetector_tpu.annotations import Keypoint as JaxKeypoint
from structuredetector_tpu.annotations import Object as JaxObject
from structuredetector_tpu.data.augment import PredictionTransformation as JaxPrediction
from structuredetector_tpu.data.augment import RandomHorizontalFlip as JaxHFlip
from structuredetector_tpu.data.augment import RandomResize as JaxRandomResize
from structuredetector_tpu.data.augment import Resize as JaxResize
from structuredetector_tpu.data.augment import ValidationAugmentation as JaxValidation
from structuredetector_tpu.data.dataset import CropDataset as JaxCropDataset
from structuredetector_tpu.data.dataset import PredictionDataset as JaxPredictionDataset
from structuredetector_tpu.data.pipeline import Loader as JaxLoader
from structuredetector_tpu.models.resnet import ResNet34Encoder
from structuredetector_tpu.models.torch_export import export_sdnet_state_dict
from structuredetector_tpu.models.torch_export import save_reference_pth as jax_save_pth
from structuredetector_tpu.ops.tensor import clamp_in_0_1 as jax_clamp_in_0_1
from structuredetector_tpu_torch import utils, visualization
from structuredetector_tpu_torch.annotations import ImageAnnotation, Keypoint, Object
from structuredetector_tpu_torch.data.augment import (
    Compose,
    PredictionTransformation,
    RandomHorizontalFlip,
    RandomResize,
    Resize,
    ValidationAugmentation,
)
from structuredetector_tpu_torch.data.dataset import CropDataset, PredictionDataset
from structuredetector_tpu_torch.data.pipeline import Loader
from structuredetector_tpu_torch.models.network import ResNetEncoder, build_model
from structuredetector_tpu_torch.models.quantize import prequantize_variables
from structuredetector_tpu_torch.models.weights import (
    export_reference_state_dict,
    jax_tree_from_state_dict,
    load_weights,
    save_reference_pth,
    state_dict_from_jax,
)
from structuredetector_tpu_torch.ops.tensor import CLAMP_EPS, clamp_in_0_1, clamped_sigmoid
from tests.test_augment import make_config, write_dataset
from tests.test_torch_port_model import nontrivial_variables, port_config

ROOT = Path(__file__).resolve().parent.parent


def _noise_image(w: int, h: int, seed: int = 3) -> Image.Image:
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


def _pair(port: bool, w: int = 100, h: int = 80):
    """A noise image and a one-object annotation in either package."""
    a, o, k = (ImageAnnotation, Object, Keypoint) if port else (JaxImageAnnotation, JaxObject,
                                                                JaxKeypoint)
    return _noise_image(w, h), a("x.jpg", [o("bean", k("stem", 10, 20), [k("leaf", 30, 40)])],
                                 (w, h))


# -- data/augment.py::RandomResize -------------------------------------------


@pytest.mark.parametrize("width,height", [(256, 256), (40, 72)])
def test_random_resize_matches_jax(width, height):
    """The same seeded rng draws the same ratio: each of 20 calls gives JAX's
    size (a multiple of 32, at least 32), pixels and annotation."""
    jax_cfg = make_config(width=width, height=height)
    ours = RandomResize(port_config(jax_cfg), rng=np.random.default_rng(0))
    theirs = JaxRandomResize(jax_cfg, rng=np.random.default_rng(0))
    sizes = set()
    for _ in range(20):
        img, ann = ours(*_pair(True))
        want_img, want_ann = theirs(*_pair(False))
        assert img.size == want_img.size
        assert all(s % 32 == 0 and s >= 32 for s in img.size)
        assert np.array_equal(np.asarray(img), np.asarray(want_img))
        assert ann.json_repr() == want_ann.json_repr()
        sizes.add(img.size)
    assert len(sizes) > 2 or width < 64


# -- visualization.py::draw_keypoints ----------------------------------------


@pytest.mark.parametrize("size", [(64, 64), (300, 180)])
def test_draw_keypoints_matches_jax(tiny_config, size):
    """Dots in the label's and the part's colours, radius max(1, min(w, h)
    // 100): byte-equal to JAX's image."""
    image = _noise_image(*size, seed=5)
    points = [("bean", 10.5, 12.0), ("maize", 40.0, 30.25), ("leaf", 20.0, 20.5)]
    ours = visualization.draw_keypoints(image, [Keypoint(*p) for p in points],
                                        port_config(tiny_config))
    theirs = jax_visualization.draw_keypoints(image, [JaxKeypoint(*p) for p in points],
                                              tiny_config)
    assert np.asarray(ours).tobytes() == np.asarray(theirs).tobytes()
    assert not np.array_equal(np.asarray(ours), np.asarray(image))


def test_draw_keypoints_unknown_kind_raises_as_jax(tiny_config):
    image = Image.new("RGB", (64, 64))
    with pytest.raises(ValueError) as theirs:
        jax_visualization.draw_keypoints(image, [JaxKeypoint("nope", 1, 1)], tiny_config)
    with pytest.raises(ValueError) as ours:
        visualization.draw_keypoints(image, [Keypoint("nope", 1, 1)], port_config(tiny_config))
    assert str(ours.value) == str(theirs.value)


# -- data/dataset.py ----------------------------------------------------------


def _two_object_file(directory: Path) -> None:
    """One more annotated image: a bean with two leaves and a maize with none."""
    Image.new("RGB", (60, 50), (10, 20, 30)).save(directory / "im_x.jpg")
    stem = {"kind": "stem", "location": {"x": 15, "y": 25}, "score": None}
    leaf = {"kind": "leaf", "location": {"x": 30, "y": 10}, "score": None}
    (directory / "im_x.json").write_text(json.dumps({
        "image_path": str(directory / "im_x.jpg"), "img_size": [60, 50],
        "objects": [{"label": "bean", "box": None, "parts": [stem, leaf, leaf]},
                    {"label": "maize", "box": None, "parts": [stem]}]}))


def test_part_count_histogram_matches_jax(tmp_path):
    """JAX's histogram data; `histogram()` imports altair as JAX's does and,
    altair not being installed, raises ModuleNotFoundError in both."""
    write_dataset(tmp_path, 3)
    _two_object_file(tmp_path)
    jax_cfg = make_config()
    ours, theirs = CropDataset(port_config(jax_cfg), tmp_path), JaxCropDataset(jax_cfg, tmp_path)
    assert ours.part_count_histogram() == theirs.part_count_histogram() == {
        "bean": {1: 3, 2: 1}, "maize": {0: 1}}
    for dataset in (ours, theirs):
        with pytest.raises(ModuleNotFoundError):
            dataset.histogram()


def test_crop_dataset_multiple_dirs_matches_jax(tmp_path):
    """JAX test_crop_dataset_multiple_dirs: a list of directories (and a
    str path) gives JAX's files in JAX's order."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_dataset(tmp_path / "a", 2)
    write_dataset(tmp_path / "b", 1)
    jax_cfg = make_config()
    cfg = port_config(jax_cfg)
    for directories in ([tmp_path / "a", tmp_path / "b"], [str(tmp_path / "b")],
                        str(tmp_path / "a"), tmp_path / "a"):
        ours, theirs = CropDataset(cfg, directories), JaxCropDataset(jax_cfg, directories)
        assert ours.files == theirs.files
    assert len(CropDataset(cfg, [tmp_path / "a", tmp_path / "b"])) == 3


def test_crop_dataset_list_transform_matches_jax(tmp_path):
    """A list transform is composed: each item is JAX's (pixels and
    annotation) through Resize then a forced horizontal flip."""
    write_dataset(tmp_path, 2)
    jax_cfg = make_config()
    ours = CropDataset(port_config(jax_cfg), tmp_path,
                       [Resize((48, 40)), RandomHorizontalFlip(prob=1.1)])
    theirs = JaxCropDataset(jax_cfg, tmp_path, [JaxResize((48, 40)), JaxHFlip(prob=1.1)])
    assert isinstance(ours.transform, Compose)
    for i in range(len(theirs)):
        (img, ann), (want_img, want_ann) = ours[i], theirs[i]
        assert np.array_equal(np.asarray(img), np.asarray(want_img))
        assert ann.json_repr() == want_ann.json_repr()


@pytest.mark.parametrize("directories", [("a", "b"), 3, None])
def test_crop_dataset_other_types_raise_as_jax(tmp_path, directories):
    jax_cfg = make_config()
    with pytest.raises(ValueError) as theirs:
        JaxCropDataset(jax_cfg, directories)
    with pytest.raises(ValueError) as ours:
        CropDataset(port_config(jax_cfg), directories)
    assert str(ours.value) == str(theirs.value)


def test_prediction_dataset_matches_jax(tmp_path):
    """JAX test_prediction_dataset: `PredictionDataset(directory, transform)`
    gives JAX's transformed images (an L-mode PNG converted to RGB), the
    original sizes and the paths; without a transform the RGB images;
    `extensions` filters."""
    _noise_image(30, 20, seed=1).save(tmp_path / "a.jpg")
    _noise_image(30, 20, seed=2).convert("L").save(tmp_path / "b.png")
    jax_cfg = make_config()
    ours = PredictionDataset(tmp_path, PredictionTransformation(port_config(jax_cfg)))
    theirs = JaxPredictionDataset(tmp_path, JaxPrediction(jax_cfg))
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        got, want = ours[i], theirs[i]
        assert got["img"].shape == (64, 64, 3)
        np.testing.assert_array_equal(got["img"], want["img"])
        assert got["img_size"] == want["img_size"] == (30, 20)
        assert got["path"] == want["path"]
    plain, jax_plain = PredictionDataset(tmp_path)[1], JaxPredictionDataset(tmp_path)[1]
    assert plain["img"].mode == "RGB"
    assert np.array_equal(np.asarray(plain["img"]), np.asarray(jax_plain["img"]))
    assert [p.name for p in PredictionDataset(tmp_path, extensions=(".png",)).images] == \
        [p.name for p in JaxPredictionDataset(tmp_path, extensions=(".png",)).images] == ["b.png"]


def _names(samples):
    """A collate_fn: the image names of a batch."""
    return [Path(s["annotation"].image_path).name for s in samples]


@pytest.mark.parametrize("workers,prefetch", [(0, 4), (2, 1), (3, 0)])
def test_loader_collate_fn_and_prefetch_batches_match_jax(tmp_path, workers, prefetch):
    """`Loader(collate_fn=, prefetch_batches=)` as JAX's: the same shuffled
    batches through the caller's collate on the serial and the pool
    routes, `prefetch_batches` at least 1; the batch-fetch route staged
    `prefetch_batches` ahead."""
    write_dataset(tmp_path, 5)
    jax_cfg = make_config()
    cfg = port_config(jax_cfg)
    ours = Loader(CropDataset(cfg, tmp_path, ValidationAugmentation(cfg)), batch_size=2,
                  shuffle=True, seed=4, num_workers=workers, collate_fn=_names,
                  prefetch_batches=prefetch)
    theirs = JaxLoader(JaxCropDataset(jax_cfg, tmp_path, JaxValidation(jax_cfg)), batch_size=2,
                       shuffle=True, seed=4, num_workers=workers, collate_fn=_names,
                       prefetch_batches=prefetch)
    assert ours.prefetch_batches == theirs.prefetch_batches == max(1, prefetch)
    assert list(ours) == list(theirs)
    fetched = Loader(ours.dataset, batch_size=2, batch_fetch=lambda idxs: list(idxs),
                     prefetch_batches=prefetch)
    assert list(fetched) == [[int(i) for i in b] for b in
                             JaxLoader(theirs.dataset, batch_size=2, prefetch_batches=prefetch,
                                       batch_fetch=lambda idxs: list(idxs))]


# -- utils.py -----------------------------------------------------------------


def test_average_meter_matches_jax():
    ours, theirs = utils.AverageMeter(), jax_utils.AverageMeter()
    for value in np.random.default_rng(0).normal(size=7).tolist():
        assert ours.update(value) == theirs.update(value)
    assert (ours.sum, ours.count, ours.avg) == (theirs.sum, theirs.count, theirs.avg)
    ours.reset()
    assert (ours.sum, ours.count, ours.avg) == (0.0, 0, 0.0)


@pytest.mark.parametrize("seed", [123, 926354916, 2**40 + 5])
def test_set_seed_seeds_numpy_as_jax_and_torch(seed):
    """numpy's global RNG as JAX `set_seed` leaves it; torch's global RNG
    seeded; the returned generator is a `torch.Generator` of `seed` (JAX
    returns a PRNG key, which the port cannot)."""
    jax_utils.set_seed(seed)
    want = np.random.random(3)
    generator = utils.set_seed(seed)
    assert np.array_equal(np.random.random(3), want)
    assert isinstance(generator, torch.Generator) and generator.initial_seed() == seed
    first = torch.rand(3)
    utils.set_seed(seed)
    assert torch.equal(torch.rand(3), first)


def test_mkdir_if_needed_as_jax(tmp_path):
    for name, fn in (("port", utils.mkdir_if_needed), ("jax", jax_utils.mkdir_if_needed)):
        fn(tmp_path / name)
        fn(tmp_path / name)  # exists: no error
        assert (tmp_path / name).is_dir()
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "missing" / name)


# -- ops/tensor.py ------------------------------------------------------------


def test_clamp_in_0_1_matches_jax_and_keeps_clamped_sigmoid():
    """JAX's clip on the edges and on random values; `clamped_sigmoid`
    through it is bit for bit the formula the kernels' plain versions ran."""
    x = np.concatenate([np.array([-1, 0, 1e-7, 0.5, 1 - 1e-7, 1, 2], np.float32),
                        np.random.default_rng(0).uniform(-0.1, 1.1, 64).astype(np.float32)])
    np.testing.assert_array_equal(clamp_in_0_1(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_clamp_in_0_1(jnp.asarray(x))))
    logits = torch.from_numpy(np.random.default_rng(1).normal(0, 8, (4, 33, 17)).astype(
        np.float32))
    assert torch.equal(clamped_sigmoid(logits),
                       torch.clamp(torch.sigmoid(logits), CLAMP_EPS, 1.0 - CLAMP_EPS))


# -- the reference .pth writer -------------------------------------------------


@pytest.fixture(scope="module")
def jax_variables(tiny_config):
    """JAX's init of `tiny_config` with perturbed BN statistics."""
    return nontrivial_variables(tiny_config, seed=21)


def _port_model(tiny_config, variables, **overrides):
    model = build_model(port_config(tiny_config, **overrides))
    if variables is not None:
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_reference_pth_matches_jax_writer(tiny_config, jax_variables, tmp_path):
    """On the same weights the port's file and JAX's load to equal
    state_dicts: the same keys in the same order, each tensor of the same
    dtype, shape and values; every `num_batches_tracked` 0-d, int64, 0
    (here after the port's BN counters moved). The file loads strictly
    into a fresh SDNet (`load_weights`) and so does JAX's."""
    jax_save_pth(jax_variables, str(tmp_path / "jax.pth"))
    model = _port_model(tiny_config, jax_variables)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.num_batches_tracked.fill_(5)
    assert save_reference_pth(model, tmp_path / "port.pth") == tmp_path / "port.pth"
    ours = torch.load(tmp_path / "port.pth", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert list(ours) == list(theirs)
    for key, want in theirs.items():
        assert ours[key].dtype == want.dtype and ours[key].shape == want.shape, key
        assert torch.equal(ours[key], want), key
        if key.endswith("num_batches_tracked"):
            assert ours[key].dim() == 0 and ours[key].dtype == torch.int64 and ours[key] == 0
    assert list(export_reference_state_dict(model.state_dict())) == list(ours)
    for path in ("port.pth", "jax.pth"):
        fresh = load_weights(build_model(port_config(tiny_config)), tmp_path / path)
        for key, value in model.state_dict().items():
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(fresh.state_dict()[key], value), key
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("overrides", [dict(head_conv=16), dict(backbone="resnet18"),
                                       dict(backbone="resnet50")],
                         ids=["head_conv", "resnet18", "resnet50"])
def test_reference_pth_refuses_what_jax_refuses(tiny_config, overrides, tmp_path):
    """`--head_conv`, resnet18 and resnet50 have no reference counterpart:
    the port raises JAX's ValueError on the same weights (the port's,
    in JAX's layout) and writes no file."""
    model = _port_model(tiny_config, None, **overrides)
    with pytest.raises(ValueError) as theirs:
        export_sdnet_state_dict(jax_tree_from_state_dict(model.state_dict()))
    with pytest.raises(ValueError) as ours:
        save_reference_pth(model, tmp_path / "m.pth")
    assert str(ours.value) == str(theirs.value)
    assert not list(tmp_path.iterdir())


def test_reference_pth_refuses_prequantized_int8(tiny_config, tmp_path):
    model = prequantize_variables(_port_model(tiny_config, None, int8=True))
    with pytest.raises(ValueError, match="int8"):
        save_reference_pth(model, tmp_path / "m.pth")


def test_resnet_encoder_matches_jax_encoder(tiny_config, jax_variables):
    """`models.ResNetEncoder` (JAX's `ResNet34Encoder`) loaded strictly with
    the encoder's tensors returns JAX's (C2, C3, C4, C5) in eval mode,
    within the fp32 forward bar of tests/test_torch_port_model.py."""
    x = np.random.default_rng(13).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    encoder_vars = {"params": jax_variables["params"]["encoder"],
                    "batch_stats": jax_variables["batch_stats"]["encoder"]}
    want = jax.jit(lambda v, x: ResNet34Encoder().apply(v, x, train=False))(
        encoder_vars, jnp.asarray(x))
    encoder = ResNetEncoder()
    encoder.load_state_dict({k: v for k, v in state_dict_from_jax(jax_variables).items()
                             if k.startswith(("adpater.", "down"))}, strict=True)
    with torch.no_grad():
        got = encoder.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.transpose(g.numpy(), (0, 2, 3, 1)), np.asarray(w),
                                   rtol=1e-3, atol=1e-4)


# -- the package API ----------------------------------------------------------

# JAX names the port renamed (the package docstring maps each)
RENAMED = {"load_params": "load_checkpoint", "save_params": "save_msgpack",
           "ResNet34Encoder": "ResNetEncoder", "make_train_step": "train_step",
           "make_eval_step": "eval_step"}


def _public_names(module) -> list:
    """A JAX package module's public names, the lazy ones of its
    `__getattr__` too; submodules left out."""
    names = [n for n, v in vars(module).items()
             if not n.startswith("_") and not isinstance(v, ModuleType)]
    lazy = getattr(module, "__getattr__", None)
    if lazy is not None:
        names += re.findall(r'name == "(\w+)"', inspect.getsource(lazy))
    return sorted(names)


@pytest.mark.parametrize("sub", ["", ".data", ".ops", ".models", ".train"])
def test_jax_names_resolve_in_the_port(sub):
    jax_module = importlib.import_module("structuredetector_tpu" + sub)
    port = importlib.import_module("structuredetector_tpu_torch" + sub)
    names = _public_names(jax_module)
    assert names, sub
    missing = [n for n in names if not hasattr(port, RENAMED.get(n, n))]
    assert not missing, missing
    assert {RENAMED.get(n, n) for n in names} <= set(port.__all__)


def test_lazy_names_are_the_modules_classes():
    import structuredetector_tpu_torch as port
    from structuredetector_tpu_torch.models.network import SDNet
    from structuredetector_tpu_torch.predictor import ExportPredictor, Predictor
    from structuredetector_tpu_torch.serve import MicroBatcher

    assert (port.Predictor, port.ExportPredictor, port.MicroBatcher, port.SDNet) == (
        Predictor, ExportPredictor, MicroBatcher, SDNet)
    assert _public_names(jax_package)  # JAX's lazy names are found
    with pytest.raises(AttributeError):
        port.NotAName  # noqa: B018


def test_package_import_loads_no_kernel_build_parallel_or_server():
    """`import structuredetector_tpu_torch` in a fresh interpreter loads no
    JAX, no `torch.utils.cpp_extension`, no `ops/kernels/_build.py`, no
    `parallel/` and no server; then every top-level name resolves."""
    code = (
        "import json, sys\n"
        "import structuredetector_tpu_torch as p\n"
        "banned = ('jax', 'jaxlib', 'structuredetector_tpu', 'torch.utils.cpp_extension', "
        "'structuredetector_tpu_torch.parallel', 'structuredetector_tpu_torch.serve', "
        "'structuredetector_tpu_torch.ops')\n"
        "loaded = sorted(m for m in sys.modules if any(m == b or m.startswith(b + '.') "
        "for b in banned))\n"
        "resolved = [getattr(p, n).__name__ for n in p.__all__]\n"
        "print(json.dumps({'loaded': loaded, 'resolved': resolved}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["resolved"] == ["Box", "Config", "ImageAnnotation", "Keypoint", "Object",
                                  "Predictor", "ExportPredictor", "MicroBatcher", "Evaluator",
                                  "Trainer", "SDNet"]
