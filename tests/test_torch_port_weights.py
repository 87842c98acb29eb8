"""The port's `.msgpack` checkpoints against the JAX package's.

A file written by JAX `save_params` (flax's msgpack) is read by the
port without flax (`models/msgpack.py`) and mapped by
`state_dict_from_jax`; the port's forward on it must match JAX
`make_forward` on the same variables at the bar of
`tests/test_torch_port_model.py` (rtol 1e-3 / atol 1e-4, fp32). The
port writes the same bytes flax does, so JAX `load_params` reads the
port's checkpoints. A checkpoint of another architecture raises a
`ValueError` that names the difference (the JAX loader loads such a
file and scores F1 0.0).
"""

import dataclasses

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from structuredetector_tpu.models.network import load_params, save_params
from structuredetector_tpu_torch.models import msgpack
from structuredetector_tpu_torch.models.network import SDNet, build_model
from structuredetector_tpu_torch.models.weights import (
    jax_tree_from_state_dict,
    load_checkpoint,
    load_weights,
    save_msgpack,
    state_dict_from_jax,
)
from structuredetector_tpu_torch.predictor import Predictor
from tests.test_torch_port_model import (
    _jax_forward,
    nontrivial_variables,
    port_config,
)


@pytest.fixture(scope="module")
def variables(tiny_config):
    return nontrivial_variables(tiny_config, seed=11)


@pytest.fixture(scope="module")
def checkpoint(variables, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "model_best_csi.msgpack"
    save_params(variables, path)
    return path


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_reader_equals_flax(checkpoint):
    """The port's reader gives flax's tree, leaf for leaf, bit for bit."""
    data = checkpoint.read_bytes()
    _assert_trees_equal(msgpack.loads(data), flax.serialization.msgpack_restore(data))


def test_writer_is_byte_identical_to_flax(variables):
    assert msgpack.dumps(variables) == flax.serialization.msgpack_serialize(variables)


def test_forward_from_jax_msgpack_matches_jax(tiny_config, variables, checkpoint):
    cfg = port_config(tiny_config)
    net = build_model(cfg, dtype=torch.float32)
    load_weights(net, checkpoint)
    images = np.random.default_rng(17).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        out = net.eval()(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    want = _jax_forward(tiny_config, variables, images)
    for key, value in out.items():
        got = np.transpose(value.numpy(), (0, 2, 3, 1))
        np.testing.assert_allclose(got, want[key], rtol=1e-3, atol=1e-4,
                                   err_msg=f"forward from .msgpack diverges on {key}")


def test_port_checkpoint_loads_in_jax(tiny_config, variables, tmp_path):
    """`save_msgpack` inverts the mapping: JAX `load_params` reads the
    port's file back into the variables it came from."""
    net = SDNet(2, 1, fpn_depth=32)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    path = save_msgpack(net, tmp_path / "port.msgpack")
    _assert_trees_equal(jax.tree.map(np.asarray, load_params(path)),
                        jax.tree.map(np.asarray, variables))
    sd = load_checkpoint(path)
    for key, value in net.state_dict().items():
        assert torch.equal(sd[key], value), key
    _assert_trees_equal(jax_tree_from_state_dict(sd), jax.tree.map(np.asarray, variables))


def test_predictor_accepts_msgpack_and_pth(tiny_config, variables, checkpoint, tmp_path):
    """Both checkpoint formats of the same weights give one annotation."""
    pth = tmp_path / "model.pth"
    torch.save(state_dict_from_jax(variables), pth)
    cfg = port_config(dataclasses.replace(tiny_config, conf_threshold=0.3))
    image = np.random.default_rng(2).integers(0, 256, (64, 64, 3), np.uint8)
    from PIL import Image

    image = Image.fromarray(image)
    a = Predictor(cfg, model_path=checkpoint, device="cpu").predict_image(image)
    b = Predictor(cfg, model_path=pth, device="cpu").predict_image(image)
    assert a.json_repr() == b.json_repr()


@pytest.mark.parametrize("change,named", [
    (dict(fpn_depth=16), "fpn_depth: 32 in the"),
    (dict(labels=["bean", "maize", "weed"]), "head outputs"),
    (dict(in_channels=4), "input channels"),
])
def test_architecture_mismatch_names_the_difference(tiny_config, checkpoint, change, named):
    cfg = port_config(tiny_config)
    labels = change.pop("labels", None)
    cfg = dataclasses.replace(cfg, **change)
    if labels:
        cfg.set_labels(labels, list(tiny_config.parts))
    with pytest.raises(ValueError, match=named):
        load_weights(build_model(cfg), checkpoint)


def test_reader_rejects_malformed_data(checkpoint):
    data = checkpoint.read_bytes()
    with pytest.raises(ValueError, match="ends inside"):
        msgpack.loads(data[:-10])
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack.loads(data + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        msgpack.loads(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="type byte"):
        msgpack.loads(b"\xc1")
