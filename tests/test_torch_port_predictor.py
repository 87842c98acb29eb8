"""Port Predictor parity and guards.

The same weights, written by the JAX package's `save_reference_pth`,
load into the port's `Predictor` (`--load_model` .pth) and into the JAX
`Predictor(fast_path=False)`. The annotations must agree: labels and
part structure exactly, coordinates within 0.5 px (the two forwards
differ by float round-off).
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from structuredetector_tpu.models.torch_export import save_reference_pth
from structuredetector_tpu.predictor import Predictor as JaxPredictor
from structuredetector_tpu_torch.predictor import Predictor
from tests.test_torch_port_model import nontrivial_variables, port_config

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "structuredetector_tpu_torch"


def _summarize(ann):
    """Per-object label + anchor (x, y) + part kinds, in a stable order."""
    return [
        (o.name, o.anchor.x, o.anchor.y, sorted(p.kind for p in o.parts))
        for o in sorted(ann.objects, key=lambda o: (o.anchor.x, o.anchor.y))
    ]


def _assert_same(got, want):
    got, want = _summarize(got), _summarize(want)
    assert len(got) == len(want) > 0
    for (ln, xn, yn, pn), (lf, xf, yf, pf) in zip(want, got):
        assert lf == ln and pf == pn
        np.testing.assert_allclose((xf, yf), (xn, yn), atol=0.5)


@pytest.fixture(scope="module")
def setup(tiny_config, tmp_path_factory):
    """A .pth of nontrivial weights, a JAX Predictor on it, and the
    port's config."""
    cfg = dataclasses.replace(tiny_config, conf_threshold=0.3)
    pth = tmp_path_factory.mktemp("weights") / "model.pth"
    save_reference_pth(nontrivial_variables(cfg, seed=3), str(pth))
    jax_predictor = JaxPredictor(cfg, model_path=pth, fast_path=False)
    return jax_predictor, port_config(cfg, pretrained_model=pth)


@pytest.fixture(scope="module")
def image():
    r = np.random.default_rng(321)
    return Image.fromarray(r.integers(0, 255, (80, 96, 3), np.uint8))


@pytest.mark.parametrize("fast_path", [False, True], ids=["decoder", "planes"])
@pytest.mark.parametrize("device_normalize", [True, False])
def test_predictor_matches_jax(setup, image, fast_path, device_normalize):
    jax_predictor, cfg = setup
    port = Predictor(cfg, device="cpu", fast_path=fast_path,
                     device_normalize=device_normalize)
    ann = port.predict_image(image)
    assert ann.img_size == image.size
    _assert_same(ann, jax_predictor.predict_image(image))


def test_predict_tiled_matches_jax(setup, image):
    jax_predictor, cfg = setup
    port = Predictor(cfg, device="cpu")
    big = image.resize((130, 90))
    _assert_same(port.predict_tiled(big, batch_size=4),
                 jax_predictor.predict_tiled(big, batch_size=4))


def test_submit_collect_split_equals_predict_batch(setup, image):
    _, cfg = setup
    port = Predictor(cfg, device="cpu")
    images = [image, image.resize((64, 64)), image.rotate(90, expand=True)]
    handle = port.predict_batch_submit(images)
    split = [a.json_repr() for a in port.predict_batch_collect(handle)]
    assert split == [a.json_repr() for a in port.predict_batch(images)]
    assert port.predict_batch_collect(port.predict_batch_submit([])) == []


def test_prepared_image_feed_equals_pil_feed(setup, image):
    from structuredetector_tpu_torch.predictor import PreparedImage

    _, cfg = setup
    port = Predictor(cfg, device="cpu")
    prepared = PreparedImage(port.transform(image), image.size)
    assert port.predict_image(prepared).json_repr()["objects"] == \
        port.predict_image(image).json_repr()["objects"]


def test_fast_path_defaults_off_on_cpu(setup):
    assert Predictor(setup[1], device="cpu").fast_path is False


def test_predictor_without_device_raises_without_cuda(setup):
    """The default device is CUDA; with none present the Predictor
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(setup[1])


def test_predictor_refuses_another_architecture(setup):
    _, cfg = setup
    with pytest.raises(RuntimeError, match="size mismatch"):
        Predictor(dataclasses.replace(cfg, fpn_depth=16), device="cpu")


# ---------------------------------------------------------------- guards

def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )


def test_port_imports_no_jax():
    """Importing every module of the port (in a fresh interpreter) loads
    neither JAX nor the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'structuredetector_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    banned = ("jax", "jaxlib", "flax", "structuredetector_tpu")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name} imports {name}"
