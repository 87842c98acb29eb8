"""The port's model variants against the JAX package's, on the CPU.

resnet18 and resnet50 backbones, the space-to-depth stem and the hidden
head (`head_conv`), at 64x64, `fpn_depth` 32, batch 2, one JAX init per
variant (BN statistics perturbed, `tests/test_torch_port_model.py`):

- the forward on the same weights and inputs: fp32 within rtol 1e-3 /
  atol 1e-4, bf16 within 4 % of each map's scale (the bars of
  `tests/test_torch_port_model.py`);
- the layout: encoder parameter counts equal JAX's (11,176,512 and
  23,508,032, `tests/test_backbones.py:35-36`), `space_to_depth` and
  `stem_kernel_to_s2d` exactly JAX's, the s2d stem conv the 7x7 conv;
- checkpoints: a JAX `.msgpack` of every variant loads into the port,
  and the port's writes load in JAX `load_params` and run in JAX's
  forward; a 7x7 checkpoint loads into an s2d model (JAX
  `_adapt_stem`), the reverse raises JAX's message; a variant mismatch
  raises by name; a torchvision resnet18/34/50 warm-starts the encoder
  as JAX's bridge does;
- the variants through the entry points: the shared parser, `Predictor`
  and a `convert_export --head_conv` artifact under `ExportPredictor`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structuredetector_tpu.config import Config as JaxConfig
from structuredetector_tpu.models.network import build_model as jax_build_model
from structuredetector_tpu.models.network import load_params, resolve_variables, save_params
from structuredetector_tpu.models.resnet import space_to_depth as jax_space_to_depth
from structuredetector_tpu.models.resnet import stem_kernel_to_s2d as jax_stem_kernel_to_s2d
from structuredetector_tpu.models.torch_bridge import (
    find_imagenet_resnet34 as jax_find_imagenet,
)
from structuredetector_tpu.train.steps import make_forward
from structuredetector_tpu_torch.cli import convert_export as convert_cli
from structuredetector_tpu_torch.config import Config, config_from_args
from structuredetector_tpu_torch.models.network import build_model, init_model
from structuredetector_tpu_torch.models.resnet import (
    Bottleneck,
    S2dStemConv,
    space_to_depth,
    stem_kernel_to_s2d,
)
from structuredetector_tpu_torch.models.weights import (
    find_imagenet_resnet34,
    jax_tree_from_state_dict,
    load_imagenet_encoder,
    load_weights,
    save_msgpack,
    state_dict_from_jax,
)
from structuredetector_tpu_torch.predictor import ExportPredictor, Predictor
from tests.test_backbones import _fake_torchvision_sd
from tests.test_torch_port_model import MAPS, _port_forward, nontrivial_variables, port_config

VARIANTS = {
    "resnet34": {},
    "resnet18": dict(backbone="resnet18"),
    "resnet50": dict(backbone="resnet50"),
    "s2d": dict(s2d_stem=True),
    "head_conv": dict(head_conv=16),
}
NEW = ["resnet18", "resnet50", "s2d", "head_conv"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU runs (the suite runs in
    several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def variant(tiny_config):
    """name -> (JAX config, its nontrivial variables), one JAX init each."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = dataclasses.replace(tiny_config, **VARIANTS[name])
            cache[name] = (cfg, nontrivial_variables(cfg))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jax_forward():
    """(variant name, config, variables, images) -> JAX `make_forward`'s
    maps, one compiled forward a variant and dtype."""
    compiled = {}

    def run(name, cfg, variables, images):
        key = (name, cfg.use_amp)
        if key not in compiled:
            compiled[key] = make_forward(jax_build_model(cfg))
        out = compiled[key](variables, jnp.asarray(images))
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    return run


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(13).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


# ------------------------------------------------------------ forward

@pytest.mark.parametrize("name", NEW)
def test_fp32_forward_matches_jax(variant, jax_forward, images, name):
    cfg, variables = variant(name)
    want = jax_forward(name, cfg, variables, images)
    got = _port_forward(port_config(cfg), variables, images, torch.float32)
    for key in MAPS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name}: port forward diverges on {key}")


@pytest.mark.parametrize("name", NEW)
def test_bf16_forward_matches_jax(variant, jax_forward, images, name):
    cfg, variables = variant(name)
    cfg = dataclasses.replace(cfg, use_amp=True)
    want = jax_forward(name, cfg, variables, images)
    got = _port_forward(port_config(cfg), variables, images, torch.bfloat16)
    for key in MAPS:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.04 * scale,
                                   err_msg=f"{name}: bf16 port forward diverges on {key}")


# ------------------------------------------------------------ layout

@pytest.mark.parametrize("name,count", [("resnet18", 11_176_512), ("resnet50", 23_508_032)])
def test_encoder_parameter_counts(variant, name, count):
    _, variables = variant(name)
    net = build_model(port_config(variant(name)[0]))
    got = sum(p.numel() for n, p in net.named_parameters() if n.startswith(("adpater", "down")))
    assert got == count == sum(x.size for x in jax.tree.leaves(variables["params"]["encoder"]))
    blocks = [m for m in net.modules() if isinstance(m, Bottleneck)]
    assert len(blocks) == (16 if name == "resnet50" else 0)
    # C5 of resnet50 is 2048 wide: the FPN takes its widths from the block
    assert net.up1.in_channels == (2048 if name == "resnet50" else 512)


def test_space_to_depth_is_jax_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    want = np.asarray(jax_space_to_depth(jax.numpy.asarray(x)))
    got = space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_stem_kernel_rewrite_is_jax_bitwise():
    k7 = np.random.default_rng(0).standard_normal((7, 7, 3, 8)).astype(np.float32)
    got, want = stem_kernel_to_s2d(k7), np.asarray(jax_stem_kernel_to_s2d(k7))
    assert got.shape == (4, 4, 12, 8) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="7x7"):
        stem_kernel_to_s2d(got)


def test_s2d_stem_conv_is_the_7x7_conv():
    """`S2dStemConv` with the rewritten kernel computes the 7x7/2 conv
    with padding 3, borders included: the asymmetric ((2, 1), (2, 1))
    padding; a symmetric one would shift every output by a pixel."""
    rng = np.random.default_rng(1)
    k7 = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 20)).astype(np.float32))
    want = F.conv2d(x, torch.from_numpy(np.transpose(k7, (3, 2, 0, 1)).copy()), stride=2,
                    padding=3)
    conv = S2dStemConv(3, 8)
    conv.weight.data = torch.from_numpy(
        np.ascontiguousarray(np.transpose(stem_kernel_to_s2d(k7), (3, 2, 0, 1))))
    got = conv(x)
    assert got.shape == want.shape == (2, 8, 8, 10)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=2e-5)


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("name", NEW)
def test_msgpack_round_trips_both_ways(variant, jax_forward, images, tmp_path, name):
    """JAX's checkpoint loads into the port and the port writes it back
    leaf for leaf; the port's own seeded model, written by the port,
    loads in JAX `load_params` and gives the port's forward in JAX's."""
    cfg, variables = variant(name)
    jax_path = tmp_path / "jax.msgpack"
    save_params(variables, jax_path)
    net = load_weights(build_model(port_config(cfg)), jax_path)
    _assert_trees_equal(load_params(save_msgpack(net, tmp_path / "back.msgpack")),
                        jax.tree.map(np.asarray, variables))

    ours = init_model(port_config(cfg))
    theirs = load_params(save_msgpack(ours, tmp_path / "port.msgpack"))
    assert set(state_dict_from_jax(theirs)) == set(ours.state_dict())
    want = jax_forward(name, cfg, theirs, images)
    with torch.inference_mode():
        got = ours(_nchw(images))
    for key in MAPS:
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), want[key],
                                   rtol=1e-3, atol=1e-4, err_msg=f"{name}: {key}")
    sd = ours.state_dict()
    for key, value in state_dict_from_jax(jax_tree_from_state_dict(sd)).items():
        assert torch.equal(value, sd[key]), key


def test_7x7_checkpoint_loads_into_s2d_model(variant, jax_forward, tmp_path):
    """JAX `_adapt_stem`: the port's s2d model on a 7x7 checkpoint gives
    the 7x7 model's outputs (atol 1e-4, rtol 1e-4, as
    `tests/test_s2d_stem.py:66-68`), its kernel JAX's rewrite bit for bit."""
    cfg, variables = variant("resnet34")
    s2d_cfg, s2d_init = variant("s2d")
    path = tmp_path / "std.msgpack"
    save_params(variables, path)
    net = load_weights(build_model(port_config(s2d_cfg)), path)
    adapted = resolve_variables(path, s2d_init)
    assert torch.equal(net.adpater[0].weight,
                       state_dict_from_jax(adapted)["adpater.0.weight"])
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax_forward("resnet34", cfg, variables, x)
    with torch.inference_mode():
        got = net.eval()(_nchw(x))
    for key in MAPS:
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), want[key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_s2d_checkpoint_refused_by_7x7_model(variant, tmp_path):
    _, s2d_vars = variant("s2d")
    _, std_init = variant("resnet34")
    path = tmp_path / "s2d.msgpack"
    save_params(s2d_vars, path)
    with pytest.raises(ValueError) as jax_error:
        resolve_variables(path, std_init)
    with pytest.raises(ValueError) as port_error:
        load_weights(build_model(port_config(variant("resnet34")[0])), path)
    assert str(port_error.value) == str(jax_error.value)
    assert "--s2d_stem" in str(port_error.value)


@pytest.mark.parametrize("saved,model,named", [
    ("resnet34", "resnet50", "block kind"),
    ("resnet50", "resnet34", "block kind"),
    ("resnet18", "resnet34", r"blocks per stage .*\(2, 2, 2, 2\) in the"),
    ("head_conv", "resnet34", r"hidden head width \(--head_conv\): 16 in the"),
    ("resnet34", "head_conv", r"hidden head width \(--head_conv\): 0 in the"),
])
def test_variant_mismatch_raises_by_name(variant, tmp_path, saved, model, named):
    """A checkpoint of another variant must raise, never load partly or
    score 0 (the JAX loader scored an export made without `--head_conv`
    F1 0.0)."""
    path = tmp_path / "other.msgpack"
    save_params(variant(saved)[1], path)
    with pytest.raises(ValueError, match=named):
        load_weights(build_model(port_config(variant(model)[0])), path)


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "s2d"])
def test_torchvision_warm_start_as_jax_bridge(variant, tmp_path, monkeypatch, name):
    """A torchvision state_dict of the backbone's family, found by
    `<backbone>-*.pth` under $TORCH_HOME as JAX finds it, fills the
    port's encoder with what JAX's bridge grafts (a 7x7 stem rewritten
    for the s2d model); the FPN and the head keep their values."""
    cfg, variables = variant(name)
    family = "resnet34" if name == "s2d" else name
    source = variant(family)[1]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v) * 1.5)
          for k, v in _fake_torchvision_sd(source).items()}
    sd["fc.weight"] = torch.zeros(10, 512 * (4 if family == "resnet50" else 1))
    where = tmp_path / "hub" / "checkpoints"
    where.mkdir(parents=True)
    torch.save(sd, where / f"{family}-0123abcd.pth")
    torch.save(sd, where / "resnet101-0123abcd.pth")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.delenv("SDNET_PRETRAINED", raising=False)
    path = find_imagenet_resnet34(family)
    assert path == jax_find_imagenet(family) == where / f"{family}-0123abcd.pth"

    net = init_model(port_config(cfg))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    load_imagenet_encoder(net, path)
    want = state_dict_from_jax(resolve_variables(path, variables))
    for key, value in net.state_dict().items():
        if key.startswith(("adpater.", "down")):
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(value, want[key]), key
        else:
            assert torch.equal(value, before[key]), key


def test_warm_start_of_another_family_raises(variant, tmp_path):
    path = tmp_path / "resnet18-0.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in _fake_torchvision_sd(variant("resnet18")[1]).items()}, path)
    with pytest.raises(ValueError, match="is a torchvision resnet18, the model's backbone "
                                         "is resnet34"):
        load_imagenet_encoder(init_model(port_config(variant("resnet34")[0])), path)
    torch.save({"conv1.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="not a torchvision resnet"):
        load_imagenet_encoder(init_model(port_config(variant("resnet34")[0])), path)


# ------------------------------------------------------------ entry points

def test_unknown_backbone_is_refused_as_jax_does():
    with pytest.raises(ValueError) as jax_error:
        JaxConfig(backbone="resnet101").validate()
    with pytest.raises(ValueError) as port_error:
        Config(backbone="resnet101").validate()
    assert str(port_error.value) == str(jax_error.value)
    assert "pick one of ['resnet18', 'resnet34', 'resnet50']" in str(port_error.value)
    with pytest.raises(SystemExit):  # the parser's choices, as JAX's
        config_from_args(["--labels", "labels.json", "--backbone", "resnet101"])


@pytest.mark.parametrize("flags,block,stem,hidden", [
    (["--backbone", "resnet18"], "BasicBlock", "Conv2d", None),
    (["--backbone", "resnet50"], "Bottleneck", "Conv2d", None),
    (["--s2d_stem"], "BasicBlock", "S2dStemConv", None),
    (["--head_conv", "16"], "BasicBlock", "Conv2d", 16),
])
def test_shared_parser_builds_the_variant(flags, block, stem, hidden):
    """Every CLI (train, evaluate, detect, serve) takes its config from
    `config_from_args`; `Predictor` builds that model."""
    cfg = config_from_args(["--labels", "labels.json", "--width", "64", "--height", "64",
                            "--fpn_depth", "32", *flags])
    model = Predictor(cfg, device="cpu").model
    assert type(model.down1[0]).__name__ == block
    assert type(model.adpater[0]).__name__ == stem
    assert (model.head_hidden.out_channels if hidden else model.head_hidden) == hidden
    assert model.head.conv.in_channels == (hidden or 32)


def test_head_conv_artifact_gives_predictor_annotations(variant, tmp_path):
    """`convert_export --head_conv 16` (bf16, the CLI's dtype) on a JAX
    checkpoint; `ExportPredictor` returns `Predictor`'s annotations."""
    from PIL import Image

    cfg, variables = variant("head_conv")
    ckpt = tmp_path / "model.msgpack"
    save_params(variables, ckpt)
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    common = ["--params", str(labels), "--width", "64", "--height", "64", "--fpn-depth", "32",
              "--uint8_input", "--dynamic_batch", "--device", "cpu"]
    with pytest.raises(ValueError, match="hidden head width"):
        convert_cli.main([str(ckpt), "-o", str(tmp_path / "bad.sdz"), *common])
    out = convert_cli.main([str(ckpt), "-o", str(tmp_path / "m.sdz"), "--head_conv", "16",
                            *common])
    rng = np.random.default_rng(5)
    pictures = [Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)) for _ in range(3)]
    live = Predictor(port_config(cfg, use_amp=True, conf_threshold=0.3, pretrained_model=ckpt),
                     device="cpu")
    want = [a.json_repr() for a in live.predict_batch(pictures)]
    assert sum(len(a["objects"]) for a in want) > 0
    ours = ExportPredictor(out, device="cpu", max_objects=4, max_parts=8, conf_threshold=0.3)
    assert [a.json_repr() for a in ours.predict_batch(pictures)] == want
