"""Port forward parity: `structuredetector_tpu_torch.models` against the JAX
SDNet on the same weights and inputs.

The weights come from the JAX `init_model` with perturbed BN statistics
(so a mapping error cannot hide behind mean 0 / var 1) and reach the
port through `models.weights.state_dict_from_jax`, loaded strictly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.models.network import build_model, init_model
from structuredetector_tpu.train.steps import make_forward
from structuredetector_tpu_torch.config import Config as PortConfig
from structuredetector_tpu_torch.models.network import SDNet, build_model as port_build_model
from structuredetector_tpu_torch.models.weights import (
    load_checkpoint,
    load_weights,
    state_dict_from_jax,
)

MAPS = ("anchor_hm", "part_hm", "offsets", "embeddings")


def nontrivial_variables(cfg, seed=7):
    """JAX init + perturbed BN stats, as numpy leaves."""
    _, variables = init_model(cfg)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = np.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
            elif k == "var":
                tree[k] = np.asarray(rng.uniform(0.75, 1.25, v.shape), v.dtype)

    perturb(variables["batch_stats"])
    return variables


def port_config(jax_cfg, **overrides) -> PortConfig:
    """The port's Config with the JAX config's model and decode fields."""
    fields = {f.name for f in dataclasses.fields(PortConfig)}
    values = {k: getattr(jax_cfg, k) for k in fields
              if k not in ("labels", "parts") and hasattr(jax_cfg, k)}
    values.update(overrides)
    cfg = PortConfig(**values)
    cfg.set_labels(list(jax_cfg.labels), list(jax_cfg.parts))
    return cfg


@pytest.fixture(scope="module")
def variables(tiny_config):
    return nontrivial_variables(tiny_config)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(13).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)


def _port_forward(cfg, variables, images, dtype):
    net = port_build_model(cfg, dtype=dtype)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        out = net.eval()(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    return {k: np.transpose(v.numpy(), (0, 2, 3, 1)) for k, v in out.items()}


def _jax_forward(cfg, variables, images):
    out = make_forward(build_model(cfg))(variables, jnp.asarray(images))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_fp32_forward_matches_jax(tiny_config, variables, images):
    want = _jax_forward(tiny_config, variables, images)
    got = _port_forward(port_config(tiny_config), variables, images, torch.float32)
    for key in MAPS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4,
                                   err_msg=f"port forward diverges on {key}")


def test_bf16_forward_matches_jax(tiny_config, variables, images):
    """bf16 on both sides rounds at different places (flax runs eval BN
    in bf16, the port's autocast runs it on f32 statistics), so the bar
    is relative to the map's scale: 4 % of its largest magnitude, twice
    the largest gap measured at this size on the CPU (2.0 %, offsets)."""
    jax_cfg = dataclasses.replace(tiny_config, use_amp=True)
    want = _jax_forward(jax_cfg, variables, images)
    got = _port_forward(port_config(jax_cfg), variables, images, torch.bfloat16)
    for key in MAPS:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.04 * scale,
                                   err_msg=f"bf16 port forward diverges on {key}")


def test_module_names_are_the_reference_layout(tiny_config, variables):
    sd = SDNet(3, 1, fpn_depth=32).state_dict()
    assert set(sd) == set(state_dict_from_jax(variables))
    for prefix in ("adpater.0.weight", "down4.0.downsample.1.running_var",
                   "up2.conv.1.weight", "up4.lateral.bias", "head.conv.weight"):
        assert prefix in sd


def test_architecture_mismatch_raises(tiny_config, variables, tmp_path):
    """A checkpoint of another architecture must not load partly (the
    JAX loader scores F1 0.0 silently on such a mismatch)."""
    path = tmp_path / "w.pth"
    torch.save(state_dict_from_jax(variables), path)
    load_weights(SDNet(2, 1, fpn_depth=32), path)  # the matching one loads
    with pytest.raises(ValueError, match="fpn_depth: 32 in the .*, 16 in the model"):
        load_weights(SDNet(2, 1, fpn_depth=16), path)
    with pytest.raises(ValueError, match=r"head outputs \(labels \+ parts \+ 4\): 7"):
        load_weights(SDNet(3, 1, fpn_depth=32), path)  # other label count
    sd = state_dict_from_jax(variables)
    del sd["up1.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_weights(SDNet(2, 1, fpn_depth=32), path)
    with pytest.raises(ValueError, match=".pth"):
        load_checkpoint(tmp_path / "w.npz")


def test_compute_dtype_is_torch():
    assert PortConfig(use_amp=True).compute_dtype == torch.bfloat16
    assert PortConfig(use_amp=False).compute_dtype == torch.float32


def test_seeded_init_draws_as_flax(tiny_config, variables):
    """The port's seeded init draws each convolution as the JAX package's
    flax modules do (LeCun normal, variance 1 / fan_in): per layer, the
    weights' standard deviation is the JAX init's within 10 %, and an
    untrained model in eval mode keeps its head maps O(1) (a fan-out He
    init grew them to ~1e3, which put every detection off the image)."""
    from structuredetector_tpu_torch.models.network import init_model as port_init_model

    net = port_init_model(port_config(tiny_config))
    want = state_dict_from_jax(variables)
    for key, value in net.state_dict().items():
        if key.endswith(".weight") and value.dim() == 4 and value.numel() >= 4096:
            ratio = float(value.std() / want[key].std())
            assert 0.9 < ratio < 1.1, (key, ratio)
    images = np.random.default_rng(3).normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    with torch.inference_mode():
        head = net(torch.from_numpy(images), raw_output=True)
    assert float(head.abs().max()) < 50.0
