"""The port's training ops against the JAX package, on the CPU.

No model is built here. Inputs come from numpy seeds and go through both
packages:

- `encode_targets` (NCHW against NHWC): indices and masks equal, the
  other fields within 1e-6;
- each loss and `sdnet_loss` (both heatmap losses): values within rtol
  1e-4, and the gradient with respect to the head output against
  `jax.grad` within rtol 1e-4 (XLA's CPU `log` is a fast approximation,
  good to about 1e-4 relative);
- `apply_augment`, fed the factors and flags drawn with `jax.random`
  exactly as `ops/device_augment.py:96-120,147-149` draws them, against
  JAX `device_augment` with the same key: normalized images within 1e-5
  (a few float32 ulps of a [0, 1] value, over ImageNet's std of ~0.22;
  XLA fuses the chain of jitter ops and rounds fewer times), keypoints
  within 1e-5 grid units; the HSV round trip alone within 1e-6;
- the host side: `flatten_annotation`, the annotation flips, the
  transforms of `TrainAugmentation` in its three modes (the same
  `np.random.default_rng` seed: equal arrays and `FlatKeypoints`) and of
  `ValidationAugmentation`, the `Loader`'s shuffle order,
  `trigger_random_resize` and the learning-rate schedule: equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from structuredetector_tpu import annotations as jax_annotations
from structuredetector_tpu.config import Config as JaxConfig
from structuredetector_tpu.data import augment as jax_augment
from structuredetector_tpu.data import pipeline as jax_pipeline
from structuredetector_tpu.ops import device_augment as jax_device_augment
from structuredetector_tpu.ops import losses as jax_losses
from structuredetector_tpu.ops.encode import encode_targets as jax_encode_targets
from structuredetector_tpu.train.state import make_lr_schedule as jax_make_lr_schedule
from structuredetector_tpu_torch import annotations
from structuredetector_tpu_torch.data import augment, pipeline
from structuredetector_tpu_torch.ops import device_augment, losses
from structuredetector_tpu_torch.ops.encode import encode_targets
from structuredetector_tpu_torch.train.state import make_lr_schedule
from tests.test_torch_port_model import port_config

B, O, P, GRID, M, N = 3, 5, 9, 16, 2, 1
KP_FIELDS = ("anchors_xy", "anchor_cls", "anchor_mask", "parts_xy", "part_kind",
             "part_owner_xy", "part_mask")


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _keypoints(seed=0):
    """A batch of padded keypoints: some slots masked, some coordinates on
    the grid's last cell (clipped input coordinates scale to just below
    GRID), classes over both labels."""
    rng = np.random.default_rng(seed)
    kp = {
        "anchors_xy": rng.uniform(0, GRID, (B, O, 2)).astype(np.float32),
        "anchor_cls": rng.integers(0, M, (B, O)).astype(np.int32),
        "anchor_mask": rng.random((B, O)) < 0.7,
        "parts_xy": rng.uniform(0, GRID, (B, P, 2)).astype(np.float32),
        "part_kind": np.zeros((B, P), np.int32),
        "part_owner_xy": rng.uniform(0, GRID, (B, P, 2)).astype(np.float32),
        "part_mask": rng.random((B, P)) < 0.7,
    }
    kp["anchors_xy"][0, 0] = (GRID - 0.25, 0.0)  # clipped to the last cell / first row
    kp["parts_xy"][1, 2] = (GRID * 63 / 64, GRID * 63 / 64)
    kp["anchor_mask"][2] = False  # an image without objects
    return kp


def _encode_both(kp):
    kw = dict(out_h=GRID, out_w=GRID, n_labels=M, n_parts=N, sigma_gauss=0.1)
    want = jax_encode_targets(*(jnp.asarray(kp[f]) for f in KP_FIELDS), **kw)
    got = encode_targets(*(torch.from_numpy(kp[f]) for f in KP_FIELDS), **kw)
    return got, want


def test_encode_targets_matches_jax():
    got, want = _encode_both(_keypoints())
    for field in ("anchor_hm", "part_hm"):
        np.testing.assert_allclose(getattr(got, field).numpy(), _nchw(getattr(want, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    assert float(got.anchor_hm.max()) == 1.0  # the peaks the focal loss counts
    for field in ("anchor_inds", "part_inds", "anchor_mask", "part_mask"):
        assert getattr(got, field).numpy().dtype == np.asarray(getattr(want, field)).dtype
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for field in ("anchor_offsets", "part_offsets", "embeddings"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    assert not got.anchor_inds[~got.anchor_mask].any()
    assert not got.embeddings[~got.part_mask].any()


# ----------------------------------------------------------------- losses

def _head(seed=1):
    rng = np.random.default_rng(seed)
    head = rng.normal(0, 2, (B, M + N + 4, GRID, GRID)).astype(np.float32)
    head[:, M + N:] = rng.uniform(-1, 1, head[:, M + N:].shape)
    return head


def _jax_outputs(head_nhwc):
    nb = M + N
    return {"anchor_hm": head_nhwc[..., :M], "part_hm": head_nhwc[..., M:nb],
            "offsets": head_nhwc[..., nb:nb + 2], "embeddings": head_nhwc[..., nb + 2:nb + 4]}


def _port_outputs(head):
    nb = M + N
    return {"anchor_hm": head[:, :M], "part_hm": head[:, M:nb], "offsets": head[:, nb:nb + 2],
            "embeddings": head[:, nb + 2:nb + 4]}


@pytest.mark.parametrize("hm_loss_fn", ["mse", "focal"])
def test_sdnet_loss_and_grad_match_jax(hm_loss_fn):
    got_t, want_t = _encode_both(_keypoints(2))
    head = _head()
    kw = dict(hm_loss_fn=hm_loss_fn, hm_weight=1.0, offset_weight=0.1, embedding_weight=0.05)

    def jax_total(h):
        return jax_losses.sdnet_loss(_jax_outputs(h), want_t, **kw)

    head_nhwc = jnp.asarray(np.transpose(head, (0, 2, 3, 1)))
    (_, want_stats), want_grad = jax.value_and_grad(jax_total, has_aux=True)(head_nhwc)
    x = torch.from_numpy(head).requires_grad_(True)
    total, stats = losses.sdnet_loss(_port_outputs(x), got_t, **kw)
    total.backward()
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(float(stats[k].detach()), float(v), rtol=1e-4, err_msg=k)
    want_grad = _nchw(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(want_grad).max())


def _regression_inputs(seed=3):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1.5, (B, 2, GRID, GRID)).astype(np.float32)
    target = rng.normal(0, 1, (B, P, 2)).astype(np.float32)
    inds = rng.integers(0, GRID * GRID, (B, P)).astype(np.int32)
    mask = rng.random((B, P)) < 0.6
    return feat, target, inds, mask


@pytest.mark.parametrize("name", ["masked_l1_loss", "masked_smooth_l1_loss", "masked_l2_loss"])
@pytest.mark.parametrize("empty", [False, True], ids=["some", "none_valid"])
def test_masked_losses_match_jax(name, empty):
    feat, target, inds, mask = _regression_inputs()
    if empty:
        mask[:] = False

    def jax_loss(f):
        return getattr(jax_losses, name)(f, jnp.asarray(target), jnp.asarray(inds),
                                         jnp.asarray(mask))

    f_nhwc = jnp.asarray(np.transpose(feat, (0, 2, 3, 1)))
    want, want_grad = jax.value_and_grad(jax_loss)(f_nhwc)
    x = torch.from_numpy(feat).requires_grad_(True)
    got = getattr(losses, name)(x, torch.from_numpy(target), torch.from_numpy(inds),
                                torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), _nchw(want_grad), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["focal_loss", "mse_loss"])
def test_heatmap_losses_match_jax(name):
    got_t, want_t = _encode_both(_keypoints(4))
    pred = 1.0 / (1.0 + np.exp(-_head(5)[:, :M]))
    pred = np.clip(pred, 1e-6, 1 - 1e-6).astype(np.float32)
    want_fn = getattr(jax_losses, name)
    want, want_grad = jax.value_and_grad(lambda p: want_fn(p, want_t.anchor_hm))(
        jnp.asarray(np.transpose(pred, (0, 2, 3, 1))))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = getattr(losses, name)(x, got_t.anchor_hm)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    want_grad = _nchw(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(want_grad).max())


def test_focal_loss_without_positives_is_the_negative_sum():
    pred = torch.full((1, 1, 4, 4), 0.25)
    want = jax_losses.focal_loss(jnp.full((1, 4, 4, 1), 0.25), jnp.zeros((1, 4, 4, 1)))
    np.testing.assert_allclose(float(losses.focal_loss(pred, torch.zeros_like(pred))),
                               float(want), rtol=1e-4)


# ---------------------------------------------------- device augmentation

def _jax_draws(key, b, flip_prob):
    """The draws of JAX `device_augment`, made as it makes them."""
    k1, k2 = jax.random.split(key)
    kb, kc, ks, kh = jax.random.split(k1, 4)

    def factor(k, s):
        return jax.random.uniform(k, (b,), minval=max(0.0, 1.0 - s), maxval=1.0 + s)

    kx, ky = jax.random.split(k2)
    draws = (factor(kb, jax_device_augment.BRIGHTNESS), factor(kc, jax_device_augment.CONTRAST),
             factor(ks, jax_device_augment.SATURATION),
             jax.random.uniform(kh, (b,), minval=-jax_device_augment.HUE,
                                maxval=jax_device_augment.HUE),
             jax.random.uniform(kx, (b,)) < flip_prob, jax.random.uniform(ky, (b,)) < flip_prob)
    return device_augment.AugmentParams(*(torch.from_numpy(np.array(d)) for d in draws))


@pytest.mark.parametrize("seed", [0, 5])
def test_apply_augment_matches_jax_device_augment(seed):
    b, h, w = 6, 32, 48
    rng = np.random.default_rng(seed)
    images = rng.random((b, h, w, 3)).astype(np.float32)
    images[0, :4] = images[0, :4, :, :1]  # grey pixels: zero saturation, hue 0
    images[1, :2] = 0.0  # black: max 0
    kp = {k: np.concatenate([v, v]) for k, v in _keypoints(seed).items()}  # 2 * B == b
    out_w, out_h = w // 4, h // 4
    key = jax.random.PRNGKey(seed)
    want_img, want_kp = jax_device_augment.device_augment(
        jnp.asarray(images), {k: jnp.asarray(v) for k, v in kp.items()}, key,
        out_w=out_w, out_h=out_h, flip_prob=0.5)
    params = _jax_draws(key, b, 0.5)
    assert params.hflip.any() and params.vflip.any() and not params.hflip.all()
    got_img, got_kp = device_augment.apply_augment(
        torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in kp.items()}, params,
        out_w=out_w, out_h=out_h)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    for name in device_augment.KEYPOINT_XY:
        np.testing.assert_allclose(got_kp[name].numpy(), np.asarray(want_kp[name]),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_flips_keep_clipped_keypoints_on_the_grid():
    """A keypoint clipped to input pixel 0 or W - 1 sits at grid 0 or
    out_w - sx; a flip swaps the two exactly, so every flipped index stays
    in [0, out_w). (An unclipped x in (out_w - sx, out_w) would flip below
    0: torch's gather raises on it where JAX's wraps the index.)"""
    w, out_w = 64, 16
    edge = (w - 1) * out_w / w
    xy = torch.tensor([[[0.0, 0.0], [edge, edge], [7.3, 2.25]]])
    kp = {name: xy.clone() for name in device_augment.KEYPOINT_XY}
    ones = torch.ones(1, dtype=torch.bool)
    params = device_augment.AugmentParams(ones, ones, ones, torch.zeros(1), ones, ones)
    _, flipped = device_augment.apply_flips(torch.zeros(1, w, w, 3), kp, params,
                                            out_w=out_w, out_h=out_w)
    got = flipped["anchors_xy"][0]
    assert got[0].tolist() == [edge, edge] and got[1].tolist() == [0.0, 0.0]
    assert float(got.min()) >= 0 and float(got.floor().max()) <= out_w - 1


def test_hsv_round_trip_matches_jax():
    rgb = np.random.default_rng(8).random((4, 16, 16, 3)).astype(np.float32)
    rgb[0, 0] = (0.5, 0.5, 0.5)
    rgb[0, 1] = 0.0
    want = jax_device_augment.rgb_to_hsv(jnp.asarray(rgb))
    got = device_augment.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    back = device_augment.hsv_to_rgb(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_device_augment.hsv_to_rgb(want)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=0, atol=1e-6)


def test_step_generator_is_a_function_of_seed_and_step():
    def draws(seed, step):
        return device_augment.draw_augment_params(8, device_augment.step_generator(seed, step),
                                                  device="cpu")

    a, b, c = draws(7, 3), draws(7, 3), draws(7, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.brightness, c.brightness)
    assert 0.75 <= float(a.brightness.min()) and float(a.brightness.max()) < 1.25
    assert float(a.hue.abs().max()) <= device_augment.HUE


# -------------------------------------------------------------- host side

def _annotation_json(rng, w, h, n_objects, n_parts):
    objects = []
    for _ in range(n_objects):
        ax, ay = float(rng.uniform(-5, w + 5)), float(rng.uniform(-5, h + 5))
        parts = [{"kind": "stem", "location": {"x": ax, "y": ay}, "score": None}]
        parts += [{"kind": "leaf", "location": {"x": ax + float(rng.normal(0, 9)),
                                                "y": ay + float(rng.normal(0, 9))},
                   "score": None} for _ in range(n_parts)]
        objects.append({"label": str(rng.choice(["bean", "maize"])),
                        "box": {"x_min": ax - 3, "y_min": ay - 4, "x_max": ax + 5,
                                "y_max": ay + 2},
                        "parts": parts})
    return {"image_path": "im.png", "img_size": [w, h], "objects": objects}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(png path, json path) of 4 annotated scenes; the last two carry more
    objects and parts than max_objects 4 and max_parts 8 hold."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(17)
    out = []
    for i, (w, h, n_obj, n_parts) in enumerate([(80, 64, 2, 1), (100, 90, 3, 2),
                                                (96, 96, 6, 2), (70, 120, 3, 5)]):
        img = Image.new("RGB", (w, h), (40, 120, 40))
        d = ImageDraw.Draw(img)
        for _ in range(6):
            x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
            d.ellipse([x - 5, y - 5, x + 5, y + 5], fill=tuple(int(c) for c in
                                                              rng.integers(0, 256, 3)))
        img.save(root / f"im_{i}.png")
        data = _annotation_json(rng, w, h, n_obj, n_parts)
        data["image_path"] = str(root / f"im_{i}.png")
        (root / f"im_{i}.json").write_text(json.dumps(data))
        out.append((root / f"im_{i}.png", root / f"im_{i}.json"))
    return out


def _load_both(png, js):
    image = Image.open(png).convert("RGB")
    ours = annotations.ImageAnnotation.from_json(js, "stem")
    theirs = jax_annotations.ImageAnnotation.from_json(js, "stem")
    ours.img_size = theirs.img_size = image.size
    return image, ours, theirs


def _assert_flat_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "FlatKeypoints"
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_flatten_annotation_matches_jax(scenes, tiny_config):
    kw = dict(labels=tiny_config.labels, parts=tiny_config.parts, max_objects=4, max_parts=8,
              in_size=(64, 64), out_size=(16, 16))
    cut = 0
    for png, js in scenes:
        _, ours, theirs = _load_both(png, js)
        ours.resize(ours.img_size, (64, 64))
        theirs.resize(theirs.img_size, (64, 64))
        got = pipeline.flatten_annotation(ours, **kw)
        _assert_flat_equal(got, jax_pipeline.flatten_annotation(theirs, **kw))
        assert ours.json_repr() == theirs.json_repr()  # clipped alike
        cut += len(ours.objects) > 4 or ours.nb_parts > 8
    assert cut >= 2, "no scene exceeds the budgets: the case tests nothing"
    # the global part budget cuts an object's parts mid-iteration
    assert int(got.part_mask.sum()) == 8


@pytest.mark.parametrize("flip", ["hflip_annotation", "vflip_annotation"])
def test_annotation_flips_match_jax(scenes, flip):
    for png, js in scenes:
        _, ours, theirs = _load_both(png, js)
        getattr(annotations, flip)(ours, (77, 55))
        getattr(jax_annotations, flip)(theirs, (77, 55))
        assert ours.json_repr() == theirs.json_repr()


def _configs(tiny_config, **kw):
    jax_cfg = dataclasses.replace(tiny_config, anchor_name="stem", native_io=False, **kw)
    return port_config(jax_cfg), jax_cfg


@pytest.mark.parametrize("mode", ["host_augment", "device_augment_u8", "device_augment_f32",
                                  "no_augmentation"])
def test_train_augmentation_matches_jax(scenes, tiny_config, mode):
    kw = {"host_augment": dict(device_augment=False),
          "device_augment_u8": dict(device_augment=True, uint8_feed=True),
          "device_augment_f32": dict(device_augment=True, uint8_feed=False),
          "no_augmentation": dict(no_augmentation=True)}[mode]
    cfg, jax_cfg = _configs(tiny_config, **kw)
    ours = augment.TrainAugmentation(cfg, rng=np.random.default_rng(3))
    theirs = jax_augment.TrainAugmentation(jax_cfg, rng=np.random.default_rng(3))
    assert (ours.device_augment, ours.uint8_feed) == (theirs.device_augment, theirs.uint8_feed)
    for epoch in range(3):
        for png, js in scenes:
            image, a, b = _load_both(png, js)
            got, want = ours(image, a), theirs(image.copy(), b)
            assert got["image"].dtype == want["image"].dtype
            np.testing.assert_array_equal(got["image"], want["image"])
            _assert_flat_equal(got["keypoints"], want["keypoints"])
            assert got["annotation"].json_repr() == want["annotation"].json_repr()
        ours.trigger_random_resize(epoch + 1)
        theirs.trigger_random_resize(epoch + 1)
        assert ours.current_size == theirs.current_size


def test_validation_augmentation_flattens_as_jax(scenes, tiny_config):
    cfg, jax_cfg = _configs(tiny_config)
    for png, js in scenes:
        image, a, b = _load_both(png, js)
        got = augment.ValidationAugmentation(cfg)(image, a)
        want = jax_augment.ValidationAugmentation(jax_cfg)(image, b)
        np.testing.assert_array_equal(got["image"], want["image"])
        _assert_flat_equal(got["keypoints"], want["keypoints"])
        assert got["annotation"].json_repr() == want["annotation"].json_repr()


def test_trigger_random_resize_matches_jax(tiny_config):
    cfg, jax_cfg = _configs(tiny_config, width=512, height=384)
    ours, theirs = augment.TrainAugmentation(cfg), jax_augment.TrainAugmentation(jax_cfg)
    sizes = set()
    for epoch in range(40):
        ours.trigger_random_resize(epoch)
        theirs.trigger_random_resize(epoch)
        assert ours.current_size == theirs.current_size, epoch
        sizes.add(ours.current_size)
    assert len(sizes) > 4
    assert sizes <= set(ours.bucket_sizes())
    assert ours.bucket_sizes()[0] == (512, 384) and len(ours.bucket_sizes()) == 9


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((1,), i, np.int64)}


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (926354916, 0), (926354916, 7),
                                        (3, 12)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shuffle_order_matches_jax(seed, epoch, drop_last):
    data = _Range(23)
    ours = pipeline.Loader(data, batch_size=4, shuffle=True, drop_last=drop_last, seed=seed,
                           num_workers=2)
    theirs = jax_pipeline.Loader(data, batch_size=4, shuffle=True, drop_last=drop_last,
                                 seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    want = [[int(i) for i in b] for b in theirs._index_batches()]
    assert ours._index_batches() == want
    assert [b["image"][:, 0].tolist() for b in ours] == want
    assert len(ours) == len(theirs) == len(want)


@pytest.mark.parametrize("epochs,lr_step", [(9, 3), (10, 3), (2, 3), (9, 0), (100, 3)])
def test_lr_schedule_matches_jax(epochs, lr_step):
    cfg = JaxConfig(epochs=epochs, lr_step=lr_step, learning_rate=1e-3)
    want = jax_make_lr_schedule(cfg, steps_per_epoch=10)
    got = make_lr_schedule(port_config(cfg.set_labels(["a"], ["b"])), steps_per_epoch=10)
    step_epochs = cfg.lr_step_epochs()
    probes = {0, 1, 9, 10, 11, epochs * 10}
    for e in range(step_epochs, epochs + 1, max(step_epochs, 1)):
        probes |= {e * 10 - 1, e * 10, e * 10 + 1}
    for step in sorted(probes):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step
    if lr_step and epochs >= 2 * lr_step:
        b = step_epochs * 10
        assert got(b - 1) == pytest.approx(1e-3) and got(b) == pytest.approx(1e-4)
