"""The port's native input tier (`structuredetector_tpu_torch/data/native.py`)
on the CPU, with the library that g++ builds from `native/sdnet_io.cpp`.

- JAX `tests/test_native_io.py`'s cases against the port's loader;
- the port's loader against JAX's `data/native.py` pointed at the same
  library (`SDNET_IO_LIB`): byte-equal on PNG and JPEG for every entry,
  mode and size;
- the port's `Loader` batches (whole-batch fetch, the per-item
  device-augment route, `--no_augmentation`) against the port's PIL path
  and JAX's `native_batch_fetch`; the `choose_batch_fetch` gating;
- the server's request decoder (three feeds) against JAX's
  `make_request_decoder`, a 400 on a truncated JPEG on both branches,
  `native_decode` in `/healthz`;
- the build: two processes at once leave one valid library, a missing
  source falls back to PIL with the reason kept, `cli.train
  --compile_cache DIR` builds under DIR, and the "pillow" route (the
  kept headers against Pillow's own libjpeg and libpng16) is byte-equal
  to PIL and builds where the system's libraries do not link.

Exact mode is byte-equal to PIL; fast mode decodes JPEG in DCT space and
is held within JAX's bars (mean 0.08 of a normalized unit on a smooth
image).
"""

import dataclasses
import io
import json
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from structuredetector_tpu import serve as jax_serve
from structuredetector_tpu.data import native as jax_native
from structuredetector_tpu.data.augment import TrainAugmentation as JaxTrainAugmentation
from structuredetector_tpu.data.augment import (
    ValidationAugmentation as JaxValidationAugmentation,
)
from structuredetector_tpu.data.dataset import CropDataset as JaxCropDataset
from structuredetector_tpu.data.pipeline import Loader as JaxLoader
from structuredetector_tpu.data.pipeline import choose_batch_fetch as jax_choose_batch_fetch
from structuredetector_tpu.data.pipeline import native_batch_fetch as jax_native_batch_fetch
from structuredetector_tpu_torch import utils
from structuredetector_tpu_torch.config import config_from_args
from structuredetector_tpu_torch.data import native
from structuredetector_tpu_torch.data.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    TrainAugmentation,
    ValidationAugmentation,
)
from structuredetector_tpu_torch.data.dataset import CropDataset
from structuredetector_tpu_torch.data.pipeline import (
    Loader,
    choose_batch_fetch,
    native_batch_fetch,
)
from structuredetector_tpu_torch.predictor import Predictor, PreparedImage
from structuredetector_tpu_torch.serve import make_request_decoder, make_server
from tests.test_torch_port_model import port_config


@pytest.fixture(scope="module", autouse=True)
def _library():
    """The library must build here: skip only where g++ or the headers are
    missing."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if not native.available():
        error = native.build_error() or ""
        if "jpeglib.h" in error or "png.h" in error:
            pytest.skip(f"the libjpeg or libpng headers are not installed: {error}")
        pytest.fail(f"the native I/O library did not build: {error}")


def _pil_reference(path, out_w, out_h):
    img = Image.open(path).convert("RGB").resize((out_w, out_h), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def smooth_image(h, w):
    """Smooth gradient image (noise images make scaled-DCT decode vs
    full-decode-then-resize legitimately diverge)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 128 + 100 * np.sin(x / w * 3.1)
    g = 128 + 100 * np.cos(y / h * 2.7)
    b = (x + y) / (w + h) * 255
    return np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8)


@pytest.fixture
def jpeg_file(tmp_path):
    p = tmp_path / "img.jpg"
    Image.fromarray(smooth_image(96, 128)).save(p, quality=95)
    return p


@pytest.fixture
def png_file(tmp_path, rng):
    arr = (rng.random((50, 70, 3)) * 255).astype(np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(arr).save(p)
    return p


# ------------------------------------------- JAX tests/test_native_io.py

def test_fast_mode_jpeg_close_to_pil(jpeg_file):
    out, orig = native.load_image(jpeg_file, 64, 48, exact=False)
    assert out.shape == (48, 64, 3)
    assert orig == (128, 96)
    want = _pil_reference(jpeg_file, 64, 48)
    assert np.abs(out - want).mean() < 0.08


@pytest.mark.parametrize("size", [(64, 48), (128, 96), (200, 150), (30, 77)])
def test_exact_mode_jpeg_bit_identical(jpeg_file, size):
    out, _ = native.load_image(jpeg_file, *size)
    np.testing.assert_array_equal(out, _pil_reference(jpeg_file, *size))


@pytest.mark.parametrize("size", [(70, 50), (32, 32), (140, 100), (65, 49)])
def test_exact_mode_png_bit_identical(png_file, size):
    out, _ = native.load_image(png_file, *size)
    np.testing.assert_array_equal(out, _pil_reference(png_file, *size))


def test_exact_mode_raw01_bit_identical(png_file):
    out, _ = native.load_image(png_file, 33, 21, normalize=False)
    img = Image.open(png_file).convert("RGB").resize((33, 21), Image.BILINEAR)
    np.testing.assert_array_equal(out, np.asarray(img, np.float32) / 255.0)


def test_load_image_jpeg_full_size_matches_pil_decode(jpeg_file):
    out, _ = native.load_image(jpeg_file, 128, 96)
    assert np.abs(out - _pil_reference(jpeg_file, 128, 96)).mean() < 5e-3


def test_load_image_png_exact_decode(png_file):
    out, orig = native.load_image(png_file, 70, 50)  # same size: no resample
    assert orig == (70, 50)
    np.testing.assert_allclose(out, _pil_reference(png_file, 70, 50), atol=2e-2)


def test_load_image_hflip(png_file):
    plain, _ = native.load_image(png_file, 70, 50)
    flipped, _ = native.load_image(png_file, 70, 50, hflip=True)
    np.testing.assert_allclose(flipped, plain[:, ::-1], atol=1e-5)


def test_load_image_vflip(png_file):
    plain, _ = native.load_image(png_file, 70, 50)
    flipped, _ = native.load_image(png_file, 70, 50, vflip=True)
    np.testing.assert_allclose(flipped, plain[::-1], atol=1e-5)


def test_load_batch(tmp_path, rng):
    paths = []
    for i in range(5):
        arr = (rng.random((40 + i, 60, 3)) * 255).astype(np.uint8)
        p = tmp_path / f"b{i}.jpg"
        Image.fromarray(arr).save(p)
        paths.append(p)
    paths.append(tmp_path / "missing.jpg")
    out, orig, ok = native.load_batch(paths, 32, 32, n_threads=3)
    assert out.shape == (6, 32, 32, 3)
    assert ok[:5].all() and not ok[5]
    assert tuple(orig[0]) == (60, 40)
    single, _ = native.load_image(paths[2], 32, 32)
    np.testing.assert_allclose(out[2], single, atol=1e-6)


def test_jpeg_scaled_decode_large(tmp_path):
    """A 1536x1024 JPEG headed for 128x128 takes the DCT-scaled decode."""
    p = tmp_path / "big.jpg"
    Image.fromarray(smooth_image(1024, 1536)).save(p, quality=90)
    out, orig = native.load_image(p, 128, 128, exact=False)
    assert orig == (1536, 1024)
    assert np.abs(out - _pil_reference(p, 128, 128)).mean() < 0.12


def test_load_image_raw01(png_file):
    out, _ = native.load_image(png_file, 70, 50, normalize=False)
    assert out.min() >= 0.0 and out.max() <= 1.0
    normed, _ = native.load_image(png_file, 70, 50, normalize=True)
    np.testing.assert_allclose(normed, (out - IMAGENET_MEAN) / IMAGENET_STD, atol=1e-5)


def test_load_batch_raw01(tmp_path, rng):
    arr = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
    p = tmp_path / "raw.png"
    Image.fromarray(arr).save(p)
    out, _, ok = native.load_batch([p, p], 60, 40, normalize=False)
    assert ok.all()
    assert out.min() >= 0.0 and out.max() <= 1.0
    single, _ = native.load_image(p, 60, 40, normalize=False)
    np.testing.assert_allclose(out[0], single, atol=1e-6)


def _write_dataset(root: Path, n: int = 5, formats=("png",)) -> Path:
    """`n` smooth images of growing size, each with a JSON annotation in
    the reference's schema (anchor kind "stem", one "leaf" part), the
    formats in turn."""
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        w, h = 64 + 4 * i, 48 + 4 * i
        ext = formats[i % len(formats)]
        img = root / f"s{i}.{ext}"
        Image.fromarray(smooth_image(h, w)).save(img, **({"quality": 90} if ext == "jpg" else {}))
        objs = [{"label": "bean", "box": None, "parts": [
            {"kind": "stem", "location": {"x": w / 3, "y": h / 3}, "score": None},
            {"kind": "leaf", "location": {"x": w / 2, "y": h / 2}, "score": None},
        ]}]
        (root / f"s{i}.json").write_text(json.dumps(
            {"image_path": str(img), "img_size": [w, h], "objects": objs}))
    return root


def _config(tiny_config, **kw):
    """The port's and JAX's configs at 32x32 with anchor "stem"."""
    jax_cfg = dataclasses.replace(tiny_config, width=32, height=32, anchor_name="stem", **kw)
    return port_config(jax_cfg), jax_cfg


def test_native_batch_loader_matches_pil_path(tmp_path, tiny_config):
    _write_dataset(tmp_path)
    cfg, _ = _config(tiny_config)
    aug = ValidationAugmentation(cfg)
    ds = CropDataset(cfg, tmp_path, aug)
    pil_batches = list(Loader(ds, batch_size=2))
    nat_batches = list(Loader(ds, batch_size=2, batch_fetch=native_batch_fetch(ds, aug, 2)))
    assert len(pil_batches) == len(nat_batches) == 3
    for pb, nb in zip(pil_batches, nat_batches):
        assert pb["image"].shape == nb["image"].shape
        np.testing.assert_array_equal(pb["image"], nb["image"])
        for f in pb["keypoints"]._fields:
            np.testing.assert_array_equal(getattr(pb["keypoints"], f),
                                          getattr(nb["keypoints"], f))
        for pa, na in zip(pb["annotation"], nb["annotation"]):
            assert pa.json_repr() == na.json_repr()


def test_choose_batch_fetch_gating(tmp_path, tiny_config):
    _write_dataset(tmp_path, n=2)
    cfg, _ = _config(tiny_config, native_io=True)
    val = ValidationAugmentation(cfg)
    ds = CropDataset(cfg, tmp_path, val)
    assert choose_batch_fetch(cfg, ds, val) is not None
    cfg_host, _ = _config(tiny_config, native_io=True, device_augment=False)
    assert choose_batch_fetch(cfg_host, ds, TrainAugmentation(cfg_host)) is None
    assert choose_batch_fetch(cfg, ds, TrainAugmentation(cfg)) is not None
    cfg_off, _ = _config(tiny_config, native_io=False)
    assert choose_batch_fetch(cfg_off, ds, val) is None


def test_load_image_u8_exact_matches_raw01(png_file):
    u8, size_u8 = native.load_image(png_file, 70, 50, normalize=False, dtype=np.uint8)
    f32, size_f = native.load_image(png_file, 70, 50, normalize=False)
    assert u8.dtype == np.uint8
    assert size_u8 == size_f
    np.testing.assert_array_equal(u8.astype(np.float32) / 255.0, f32)


def test_load_image_u8_matches_pil_pixels(png_file):
    u8, _ = native.load_image(png_file, 33, 21, normalize=False, dtype=np.uint8)
    pil = Image.open(png_file).convert("RGB").resize((33, 21), Image.BILINEAR)
    np.testing.assert_array_equal(u8, np.asarray(pil, np.uint8))


def test_load_image_u8_flips(png_file):
    base, _ = native.load_image(png_file, 24, 18, normalize=False, dtype=np.uint8)
    hf, _ = native.load_image(png_file, 24, 18, hflip=True, normalize=False, dtype=np.uint8)
    vf, _ = native.load_image(png_file, 24, 18, vflip=True, normalize=False, dtype=np.uint8)
    np.testing.assert_array_equal(hf, base[:, ::-1])
    np.testing.assert_array_equal(vf, base[::-1])


def test_load_batch_u8_matches_float(tmp_path, rng):
    arr = (rng.random((40, 60, 3)) * 255).astype(np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(arr).save(p)
    u8, orig_u8, ok_u8 = native.load_batch([p, p], 48, 32, normalize=False, dtype=np.uint8)
    f32, orig_f, ok_f = native.load_batch([p, p], 48, 32, normalize=False)
    assert ok_u8.all() and ok_f.all()
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(orig_u8, orig_f)
    np.testing.assert_array_equal(u8.astype(np.float32) / 255.0, f32)


def test_load_image_u8_fast_mode_close_to_float(jpeg_file):
    """Fast mode rounds the bilinear result to uint8: within half a level
    of the float fast path."""
    u8, _ = native.load_image(jpeg_file, 64, 48, normalize=False, exact=False, dtype=np.uint8)
    f32, _ = native.load_image(jpeg_file, 64, 48, normalize=False, exact=False)
    assert np.abs(u8.astype(np.float32) / 255.0 - f32).max() <= 0.5 / 255 + 1e-6


def test_decode_bytes_jpeg_matches_load_image(jpeg_file):
    mem, size_mem = native.decode_bytes(jpeg_file.read_bytes(), 64, 48)
    file, size_file = native.load_image(jpeg_file, 64, 48)
    assert size_mem == size_file == (128, 96)
    np.testing.assert_array_equal(mem, file)


def test_decode_bytes_png_u8_matches_pil(png_file):
    mem, size = native.decode_bytes(png_file.read_bytes(), 32, 24, normalize=False,
                                    dtype=np.uint8)
    assert size == (70, 50)
    pil = np.asarray(Image.open(png_file).convert("RGB").resize((32, 24), Image.BILINEAR))
    np.testing.assert_array_equal(mem, pil)


def test_decode_bytes_rejects_garbage():
    with pytest.raises(IOError):
        native.decode_bytes(b"not an image at all", 32, 32)
    with pytest.raises(IOError):
        native.decode_bytes(b"\xff\xd8\xff\xe0trunc", 32, 32)  # a JPEG SOI, then nothing


def test_decode_bytes_rejects_mid_scan_truncation(jpeg_file):
    """libjpeg 'decodes' a JPEG cut mid-scan with a warning; PIL raises,
    and so must the native decoder (a 400, not half-gray detections)."""
    cut = jpeg_file.read_bytes()[: int(jpeg_file.stat().st_size * 0.6)]
    with pytest.raises(IOError):
        native.decode_bytes(cut, 32, 32)
    trunc = jpeg_file.parent / "trunc.jpg"
    trunc.write_bytes(cut)
    with pytest.raises(IOError):
        native.load_image(trunc, 32, 32)


def test_decode_bytes_tolerates_benign_corrupt_data_warning(jpeg_file):
    """Trailing garbage before EOI decodes in PIL and must decode here,
    byte-equal to the clean stream."""
    data = jpeg_file.read_bytes()
    assert data[-2:] == b"\xff\xd9"
    noisy = data[:-2] + b"\x00garbage\x00" + data[-2:]
    clean, size_clean = native.decode_bytes(data, 32, 32)
    out, size = native.decode_bytes(noisy, 32, 32)
    assert size == size_clean
    np.testing.assert_array_equal(out, clean)
    noisy_path = jpeg_file.parent / "noisy.jpg"
    noisy_path.write_bytes(noisy)
    out_f, _ = native.load_image(noisy_path, 32, 32)
    np.testing.assert_array_equal(out_f, clean)


def test_dataset_item_falls_back_to_pil_without_device_augment(tmp_path, tiny_config):
    """--native_io with --no_augmentation takes the PIL item path (the
    per-item native route is the device-augment feed's only)."""
    Image.fromarray(smooth_image(64, 64)).save(tmp_path / "im.jpg")
    (tmp_path / "im.json").write_text(json.dumps({
        "image_path": str(tmp_path / "im.jpg"), "img_size": [64, 64],
        "objects": [{"label": "bean", "box": None, "parts": [
            {"kind": "stem", "location": {"x": 30, "y": 30}, "score": None}]}]}))
    cfg = port_config(tiny_config, no_augmentation=True, native_io=True, anchor_name="stem")
    sample = CropDataset(cfg, tmp_path, TrainAugmentation(cfg))[0]
    assert sample["image"].shape == (64, 64, 3)


# ------------------------------------------------ the port against JAX

@pytest.fixture
def jax_loader(monkeypatch):
    """JAX's `data/native.py`, pointed at the library the port built."""
    monkeypatch.setenv("SDNET_IO_LIB", str(native.library_path()))
    monkeypatch.setattr(jax_native, "_TRIED", False)
    monkeypatch.setattr(jax_native, "_LIB", None)
    assert jax_native.available() and jax_native.supports_decode_bytes()
    return jax_native


@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    """A PNG set (noise) and a JPEG set (smooth, JPEG's own kind of image)."""
    root = tmp_path_factory.mktemp("sets")
    rng = np.random.default_rng(5)
    sets = {"png": [], "jpeg": []}
    for i, (w, h) in enumerate([(70, 50), (128, 96), (33, 61), (200, 150)]):
        p = root / f"n{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(p)
        sets["png"].append(p)
        j = root / f"s{i}.jpg"
        Image.fromarray(smooth_image(h, w)).save(j, quality=85)
        sets["jpeg"].append(j)
    return sets


MODES = {
    "normalized": dict(normalize=True),
    "raw01": dict(normalize=False),
    "uint8": dict(normalize=False, dtype=np.uint8),
    "fast_normalized": dict(normalize=True, exact=False),
    "fast_uint8": dict(normalize=False, exact=False, dtype=np.uint8),
}
SIZES = [(64, 48), (32, 32), (96, 130), (17, 9)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_load_image_equals_jax(jax_loader, image_sets, fmt, mode):
    for path in image_sets[fmt]:
        for size in SIZES:
            for flips in ((False, False), (True, False), (False, True)):
                got, got_size = native.load_image(path, *size, *flips, **MODES[mode])
                want, want_size = jax_loader.load_image(path, *size, *flips, **MODES[mode])
                assert got.dtype == want.dtype and got_size == want_size
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_decode_bytes_equals_jax(jax_loader, image_sets, fmt, mode):
    for path in image_sets[fmt]:
        data = path.read_bytes()
        for size in SIZES:
            got, got_size = native.decode_bytes(data, *size, **MODES[mode])
            want, want_size = jax_loader.decode_bytes(data, *size, **MODES[mode])
            assert got.dtype == want.dtype and got_size == want_size
            np.testing.assert_array_equal(got, want)
            # the file entry gives the same bytes as the in-memory one
            np.testing.assert_array_equal(got, native.load_image(path, *size, **MODES[mode])[0])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_load_batch_equals_jax(jax_loader, image_sets, fmt, mode):
    paths = image_sets[fmt] + [image_sets[fmt][0].parent / "missing.png"]
    flips = np.array([[0, 0], [1, 0], [0, 1], [1, 1], [0, 0]], np.int32)
    for size in SIZES:
        got = native.load_batch(paths, *size, flips=flips, n_threads=3, **MODES[mode])
        want = jax_loader.load_batch(paths, *size, flips=flips, n_threads=3, **MODES[mode])
        assert got[2].tolist() == want[2].tolist() == [True] * 4 + [False]
        assert got[0].dtype == want[0].dtype
        # the failed slot is left as it was allocated: compare the others
        np.testing.assert_array_equal(got[0][:4], want[0][:4])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_exact_modes_equal_pil(image_sets, fmt):
    """Exact mode, every entry, byte-equal to PIL's resize and the port's
    float32 operations (`Normalize`, `Raw01`, `RawU8`)."""
    from structuredetector_tpu_torch.data.augment import Normalize, Raw01, RawU8

    for path in image_sets[fmt]:
        for w, h in SIZES:
            resized = Image.open(path).convert("RGB").resize((w, h), Image.BILINEAR)
            for kw, want in ((MODES["normalized"], Normalize()(resized)),
                             (MODES["raw01"], Raw01()(resized)),
                             (MODES["uint8"], RawU8()(resized))):
                np.testing.assert_array_equal(native.load_image(path, w, h, **kw)[0], want)
                np.testing.assert_array_equal(
                    native.decode_bytes(path.read_bytes(), w, h, **kw)[0], want)
                np.testing.assert_array_equal(
                    native.load_batch([path], w, h, **kw)[0][0], want)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["image"].dtype == b["image"].dtype
        np.testing.assert_array_equal(a["image"], b["image"])
        for f in a["keypoints"]._fields:
            np.testing.assert_array_equal(getattr(a["keypoints"], f),
                                          getattr(b["keypoints"], f))
        assert [x.json_repr() for x in a["annotation"]] == \
            [x.json_repr() for x in b["annotation"]]


LOADER_MODES = {
    "validation": dict(),
    "device_augment_uint8": dict(device_augment=True, uint8_feed=True),
    "device_augment_float": dict(device_augment=True, uint8_feed=False),
    "no_augmentation": dict(no_augmentation=True),
}


@pytest.mark.parametrize("mode", list(LOADER_MODES))
def test_loader_whole_batch_equals_pil_and_jax(jax_loader, tmp_path, tiny_config, mode):
    """Whole-batch fetch: images byte-equal and keypoints equal to the
    port's PIL path and to JAX's `native_batch_fetch`, at the current
    multi-scale size."""
    _write_dataset(tmp_path, n=7, formats=("png", "jpg"))
    cfg, jax_cfg = _config(tiny_config, **LOADER_MODES[mode])
    if mode == "validation":
        ours, theirs = ValidationAugmentation(cfg), JaxValidationAugmentation(jax_cfg)
    else:
        ours, theirs = TrainAugmentation(cfg), JaxTrainAugmentation(jax_cfg)
        ours.trigger_random_resize(3)
        theirs.trigger_random_resize(3)
        assert ours.current_size == theirs.current_size
    ds, jax_ds = CropDataset(cfg, tmp_path, ours), JaxCropDataset(jax_cfg, tmp_path, theirs)
    fetch = choose_batch_fetch(cfg, ds, ours)
    assert fetch is not None
    native_batches = list(Loader(ds, batch_size=3, batch_fetch=fetch))
    pil_cfg = dataclasses.replace(cfg, native_io=False)
    pil_batches = list(Loader(CropDataset(pil_cfg, tmp_path, ours), batch_size=3,
                              num_workers=2))
    jax_batches = list(JaxLoader(jax_ds, batch_size=3,
                                 batch_fetch=jax_native_batch_fetch(jax_ds, theirs, 2)))
    _assert_batches_equal(native_batches, pil_batches)
    _assert_batches_equal(native_batches, jax_batches)


@pytest.mark.parametrize("uint8_feed", [True, False])
def test_dataset_item_native_route_equals_pil_and_jax(jax_loader, tmp_path, tiny_config,
                                                       uint8_feed):
    """The per-item route of the device-augment feed: `dataset[i]` decodes
    natively, equal to the PIL item and to JAX's native item."""
    _write_dataset(tmp_path, n=4, formats=("jpg", "png"))
    cfg, jax_cfg = _config(tiny_config, device_augment=True, uint8_feed=uint8_feed)
    ours = TrainAugmentation(cfg)
    ds = CropDataset(cfg, tmp_path, ours)
    pil_ds = CropDataset(dataclasses.replace(cfg, native_io=False), tmp_path, ours)
    jax_ds = JaxCropDataset(jax_cfg, tmp_path, JaxTrainAugmentation(jax_cfg))
    calls = []
    real = native.load_image
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load_image", lambda *a, **k: calls.append(a) or real(*a, **k))
        items = [ds[i] for i in range(len(ds))]
    assert len(calls) == len(ds)
    for i, item in enumerate(items):
        for other in (pil_ds[i], jax_ds[i]):
            assert item["image"].dtype == other["image"].dtype
            np.testing.assert_array_equal(item["image"], other["image"])
            for f in item["keypoints"]._fields:
                np.testing.assert_array_equal(getattr(item["keypoints"], f),
                                              getattr(other["keypoints"], f))


def test_fast_feed_follows_native_io_fast(jax_loader, tmp_path, tiny_config):
    """`--native_io_fast` decodes the training feed in fast mode, as JAX's
    does; validation stays exact."""
    _write_dataset(tmp_path, n=3, formats=("jpg",))
    cfg, jax_cfg = _config(tiny_config, device_augment=True, native_io_fast=True)
    ours, theirs = TrainAugmentation(cfg), JaxTrainAugmentation(jax_cfg)
    ds, jax_ds = CropDataset(cfg, tmp_path, ours), JaxCropDataset(jax_cfg, tmp_path, theirs)
    got = choose_batch_fetch(cfg, ds, ours)([0, 1, 2])
    want = jax_choose_batch_fetch(jax_cfg, jax_ds, theirs)([0, 1, 2])
    np.testing.assert_array_equal(got["image"], want["image"])
    paths = [ds.raw_item(i)[0] for i in range(3)]
    fast = native.load_batch(paths, 32, 32, normalize=False, exact=False, dtype=np.uint8)[0]
    np.testing.assert_array_equal(got["image"], fast)
    val = ValidationAugmentation(cfg)
    exact = choose_batch_fetch(cfg, CropDataset(cfg, tmp_path, val), val)([0, 1, 2])
    np.testing.assert_array_equal(exact["image"], native.load_batch(paths, 32, 32)[0])


GATING = {
    "validation": (dict(), "validation"),
    "device_augment": (dict(), "train"),
    "host_augment": (dict(device_augment=False), "train"),
    "no_augmentation": (dict(no_augmentation=True), "train"),
    "native_io_off": (dict(native_io=False), "validation"),
    "native_io_off_train": (dict(native_io=False), "train"),
}


@pytest.mark.parametrize("case", list(GATING))
def test_choose_batch_fetch_gating_equals_jax(jax_loader, tmp_path, tiny_config, case):
    _write_dataset(tmp_path, n=2)
    kw, kind = GATING[case]
    cfg, jax_cfg = _config(tiny_config, **kw)
    if kind == "validation":
        ours, theirs = ValidationAugmentation(cfg), JaxValidationAugmentation(jax_cfg)
    else:
        ours, theirs = TrainAugmentation(cfg), JaxTrainAugmentation(jax_cfg)
    got = choose_batch_fetch(cfg, CropDataset(cfg, tmp_path, ours), ours)
    want = jax_choose_batch_fetch(jax_cfg, JaxCropDataset(jax_cfg, tmp_path, theirs), theirs)
    assert (got is None) == (want is None)
    assert (got is None) == (case in ("host_augment", "native_io_off", "native_io_off_train"))


def test_loader_batch_fetch_raises_at_the_failing_batch(tmp_path, tiny_config):
    """A file that fails to decode raises IOError naming it, at its batch,
    and the coordinator thread ends."""
    _write_dataset(tmp_path, n=4)
    (tmp_path / "s3.png").write_bytes(b"not a png")
    cfg, _ = _config(tiny_config)
    aug = ValidationAugmentation(cfg)
    ds = CropDataset(cfg, tmp_path, aug)
    it = iter(Loader(ds, batch_size=2, batch_fetch=choose_batch_fetch(cfg, ds, aug)))
    assert next(it)["image"].shape == (2, 32, 32, 3)
    with pytest.raises(IOError, match="s3.png"):
        next(it)
    before = threading.active_count()
    early = iter(Loader(ds, batch_size=1, batch_fetch=choose_batch_fetch(cfg, ds, aug)))
    next(early)
    early.close()  # a consumer that stops early joins the coordinator
    assert threading.active_count() == before


# ----------------------------------------------------------- serving

def _jpeg(seed: int, size) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(smooth_image(size[1], size[0])[:, ::-1] // (1 + seed % 3)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _png(seed: int, size) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


FEEDS = {"uint8": (True, False), "normalized": (False, True), "raw255": (False, False)}


@pytest.mark.parametrize("feed", list(FEEDS))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_request_decoder_feeds_equal_jax(jax_loader, tiny_config, feed, fmt):
    """The three feeds of `make_request_decoder` against JAX's: the same
    array, dtype and original size; and equal to the PIL transform of
    the predictor's feed."""
    from structuredetector_tpu_torch.data.augment import Normalize

    feed_u8, feed_norm = FEEDS[feed]
    cfg, jax_cfg = _config(tiny_config)
    decode = make_request_decoder(SimpleNamespace(config=cfg, feed_uint8=feed_u8,
                                                  feed_normalize=feed_norm), True)
    jax_decode = jax_serve.make_request_decoder(
        SimpleNamespace(config=jax_cfg, feed_uint8=feed_u8, feed_normalize=feed_norm), True)
    make = _png if fmt == "png" else _jpeg
    for seed, size in enumerate([(70, 50), (32, 32), (100, 140)]):
        body = make(seed, size)
        got, want = decode(body), jax_decode(body)
        assert isinstance(got, PreparedImage)
        assert got.size == tuple(want.size) == size
        assert got.array.dtype == want.array.dtype
        np.testing.assert_array_equal(got.array, want.array)
        resized = Image.open(io.BytesIO(body)).convert("RGB").resize((32, 32), Image.BILINEAR)
        pil = (np.asarray(resized, np.uint8) if feed_u8 else Normalize()(resized) if feed_norm
               else np.asarray(resized, np.float32))
        np.testing.assert_array_equal(got.array, pil)


@pytest.fixture(scope="module")
def predictor(tiny_config):
    return Predictor(port_config(tiny_config, conf_threshold=0.3), device="cpu")


def _serve(predictor):
    srv, batcher = make_server(predictor, "127.0.0.1", 0, max_batch=4, window_ms=20.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def stop():
        srv.shutdown()
        srv.server_close()
        batcher.close()
        thread.join(timeout=10)
        assert not thread.is_alive()

    return url, stop


def _post(url, body):
    req = urllib.request.Request(url + "/detect", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _health(url):
    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("use_native", [True, False])
def test_server_rejects_truncated_jpeg_with_400(predictor, monkeypatch, use_native):
    """A truncated or garbage body gets a 400 on both decode branches, and
    /healthz says which branch served."""
    monkeypatch.setattr(native, "supports_decode_bytes", lambda: use_native)
    url, stop = _serve(predictor)
    try:
        assert _health(url)["model"]["native_decode"] is use_native
        body = _jpeg(0, (96, 80))
        for bad in (body[: int(len(body) * 0.6)], b"\xff\xd8\xff\xe0trunc", b"garbage"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, bad)
            assert err.value.code == 400
        assert _post(url, body)["img_size"] == [96, 80]
    finally:
        stop()


@pytest.mark.parametrize("device_normalize", [False, True])
def test_native_server_answers_equal_pil_server(predictor, tiny_config, monkeypatch,
                                                device_normalize):
    """The native server (the default here) answers as the PIL server does
    on PNG and JPEG requests, for both feeds of the Predictor."""
    pred = predictor
    if device_normalize:
        pred = Predictor(port_config(tiny_config, conf_threshold=0.3), device="cpu",
                         device_normalize=True)
        pred.model.load_state_dict(predictor.model.state_dict())
    bodies = [_png(1, (70, 90)), _jpeg(2, (128, 96)), _png(3, (64, 64)), _jpeg(4, (50, 110))]
    answers = {}
    for use_native in (True, False):
        monkeypatch.setattr(native, "supports_decode_bytes",
                            (lambda: True) if use_native else (lambda: False))
        url, stop = _serve(pred)
        try:
            assert _health(url)["model"]["native_decode"] is use_native
            answers[use_native] = [_post(url, b) for b in bodies]
        finally:
            stop()
    assert answers[True] == answers[False]


def test_server_health_reports_native_decode_by_default(predictor):
    url, stop = _serve(predictor)
    try:
        assert _health(url)["model"]["native_decode"] is True
    finally:
        stop()


# -------------------------------------------------------------- build

_BUILD_SCRIPT = """
import sys
from structuredetector_tpu_torch import utils
from structuredetector_tpu_torch.data import native
utils.set_build_dir(sys.argv[1])
print(native.build())
"""


def test_concurrent_builds_leave_one_valid_library(tmp_path):
    """Two processes build into one empty directory at once: one library,
    no temporary file left, and it loads at version 4."""
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == [native.library_path().name], files
    import ctypes

    assert ctypes.CDLL(str(tmp_path / files[0])).sdnet_io_version() >= native.MIN_VERSION


def test_missing_source_falls_back_with_the_reason(monkeypatch, tmp_path, tiny_config, capsys):
    """Without the library the callers decode with PIL; the reason is kept
    and printed once."""
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "absent.cpp")
    assert not native.available()
    assert not native.available()
    assert "absent.cpp" in native.build_error()
    assert capsys.readouterr().err.count("native I/O unavailable") == 1
    with pytest.raises(RuntimeError, match="absent.cpp"):
        native.load_image(tmp_path / "x.png", 8, 8)
    _write_dataset(tmp_path / "set", n=2)
    cfg, _ = _config(tiny_config)
    aug = ValidationAugmentation(cfg)
    ds = CropDataset(cfg, tmp_path / "set", aug)
    assert choose_batch_fetch(cfg, ds, aug) is None
    assert ds[0]["image"].shape == (32, 32, 3)


def test_cli_flags_set_native_io(tmp_path):
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean"], "parts": ["leaf"]}))
    base = ["--labels", str(labels)]
    on = config_from_args(base)
    assert (on.native_io, on.native_io_fast, on.compile_cache) == (True, False, "")
    assert not config_from_args([*base, "--no_native_io"]).native_io
    fast = config_from_args([*base, "--no_native_io", "--native_io_fast"])
    assert (fast.native_io, fast.native_io_fast) == (True, True)  # fast implies native
    assert config_from_args([*base, "--compile_cache", str(tmp_path)]).compile_cache == \
        str(tmp_path)


def test_compile_cache_builds_under_the_directory(monkeypatch, tmp_path):
    """`cli.train --compile_cache DIR`: the native library is built under
    DIR, and the train and valid loaders take the native path."""
    from structuredetector_tpu_torch.cli import train as cli_train
    from structuredetector_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(utils, "_build_dir", utils.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(Trainer, "train", lambda self: None)  # the set-up is under test
    monkeypatch.chdir(tmp_path)
    data = _write_dataset(tmp_path / "data", n=4)
    (tmp_path / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                      "parts": ["leaf"]}))
    cache = tmp_path / "cache"
    trainer = cli_train.main([
        "--device", "cpu", "--train_dir", str(data), "--valid_dir", str(data), "--labels",
        str(tmp_path / "labels.json"), "--anchor_name", "stem", "--width", "32", "--height",
        "32", "--fpn_depth", "16", "--batch_size", "2", "--no_amp", "--compile_cache",
        str(cache)])
    assert utils.build_dir() == cache.resolve()
    assert native.library_path().parent == cache.resolve()
    assert [f.name for f in cache.iterdir()] == [native.library_path().name]
    assert trainer.train_loader.batch_fetch is not None
    assert trainer.valid_loader.batch_fetch is not None
    batch = next(iter(trainer.train_loader))
    assert batch["image"].dtype == np.uint8 and batch["image"].shape[0] == 2


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and a library not yet loaded."""
    monkeypatch.setattr(utils, "_build_dir", tmp_path / "build")
    for name, value in (("_TRIED", False), ("_LIB", None), ("_ROUTE", None),
                        ("_BUILD_ERROR", None)):
        monkeypatch.setattr(native, name, value)
    if not any(r.name == "pillow" for r in native.routes()):
        pytest.skip("this Pillow links the system's libjpeg and libpng (no pillow.libs/)")
    return tmp_path / "build"


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_pillow_route_exact_modes_equal_pil(monkeypatch, fresh_build, image_sets, fmt):
    """The library built from the kept headers against Pillow's own
    libjpeg and libpng16 (the route of a host without the -dev packages)
    is byte-equal to PIL in exact mode, every entry."""
    from structuredetector_tpu_torch.data.augment import Normalize, Raw01, RawU8

    pillow = [r for r in native.routes() if r.name == "pillow"]
    monkeypatch.setattr(native, "routes", lambda: pillow)
    assert native.available() and native.route() == "pillow"
    assert [f.name for f in fresh_build.iterdir()] == [native.library_path().name]
    for path in image_sets[fmt]:
        for w, h in SIZES:
            resized = Image.open(path).convert("RGB").resize((w, h), Image.BILINEAR)
            for kw, want in ((MODES["normalized"], Normalize()(resized)),
                             (MODES["raw01"], Raw01()(resized)),
                             (MODES["uint8"], RawU8()(resized))):
                np.testing.assert_array_equal(native.load_image(path, w, h, **kw)[0], want)
                np.testing.assert_array_equal(
                    native.decode_bytes(path.read_bytes(), w, h, **kw)[0], want)
                np.testing.assert_array_equal(
                    native.load_batch([path], w, h, **kw)[0][0], want)


def test_failed_system_route_builds_the_pillow_route(monkeypatch, fresh_build, jpeg_file):
    """Where the system's libraries do not link, the next route builds:
    no error is kept and the one library in the directory is Pillow's."""
    monkeypatch.setattr(native, "LIBS", ("-lsdnet_absent_library", *native.LIBS))
    assert native.available() and native.route() == "pillow"
    assert native.build_error() is None
    assert [f.name for f in fresh_build.iterdir()] == [native.library_path().name]
    got, size = native.load_image(jpeg_file, 64, 48)
    np.testing.assert_array_equal(got, _pil_reference(jpeg_file, 64, 48))
    assert size == (128, 96)
