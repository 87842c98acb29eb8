"""Port decode parity: the same logits through the JAX
`decode_feature_maps` and through both port decodes (the `Decoder` front
with kernel A, and the serving plane decode with kernel B; on the CPU
their wrappers run the plain versions).

Detection rows compare at atol 1e-5 (the sigmoid of XLA and of torch
may differ by an ulp on the CPU); selections, parents and link flags
compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.ops.decode import decode_feature_maps as jax_decode
from structuredetector_tpu_torch.ops.decode import (
    decode_feature_maps,
    decode_feature_maps_planes,
    split_head_output,
)
from structuredetector_tpu_torch.ops.kernels import sigmoid_nms

M, N, K, P = 2, 1, 6, 12


@pytest.fixture(scope="module")
def head():
    """(B, M+N+4, H, W) logits with a plateau and regressed maps whose
    part origins land near anchors often enough to link."""
    rng = np.random.default_rng(5)
    raw = rng.normal(0, 2, (3, M + N + 4, 16, 20)).astype(np.float32)
    raw[0, 0, 3:6, 3:6] = 3.0
    raw[:, M + N :] = rng.uniform(-1.5, 1.5, raw[:, M + N :].shape)
    return raw


def _jax(head, conf, dist):
    nhwc = jnp.asarray(np.transpose(head, (0, 2, 3, 1)))
    nb = M + N
    outputs = {
        "anchor_hm": nhwc[..., :M], "part_hm": nhwc[..., M:nb],
        "offsets": nhwc[..., nb : nb + 2], "embeddings": nhwc[..., nb + 2 : nb + 4],
    }
    dec = jax_decode(outputs, max_objects=K, max_parts=P, conf_thresh=conf,
                     dist_thresh=dist, with_metadata=False)
    return {k: np.asarray(v) for k, v in dec.items()}


def _port(head, conf, dist, planes: bool):
    outputs = split_head_output(torch.from_numpy(head), M, N)
    kw = dict(max_objects=K, max_parts=P, conf_thresh=conf, dist_thresh=dist)
    if planes:
        dec = decode_feature_maps_planes(outputs, **kw)
    else:
        dec = decode_feature_maps(outputs, nms_fn=sigmoid_nms, **kw)
    return {k: v.numpy() for k, v in dec.items()}


@pytest.mark.parametrize("planes", [False, True], ids=["kernel_a_front", "kernel_b_front"])
@pytest.mark.parametrize("conf,dist", [(0.5, 0.1), (0.2, 0.3)])
def test_decode_matches_jax(head, planes, conf, dist):
    want = _jax(head, conf, dist)
    got = _port(head, conf, dist, planes)
    assert set(got) == {"anchors", "parts", "part_parent", "part_valid"}
    np.testing.assert_allclose(got["anchors"], want["anchors"], atol=1e-5)
    np.testing.assert_allclose(got["parts"], want["parts"], atol=1e-5)
    np.testing.assert_array_equal(got["part_parent"], want["part_parent"])
    np.testing.assert_array_equal(got["part_valid"], want["part_valid"])
    assert got["part_parent"].dtype == np.int32
    if conf == 0.2:
        assert got["part_valid"].any(), "no part linked: the case tests nothing"


def test_both_port_fronts_agree_exactly(head):
    a = _port(head, 0.3, 0.2, planes=False)
    b = _port(head, 0.3, 0.2, planes=True)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_plain_front_equals_kernel_front(head):
    outputs = split_head_output(torch.from_numpy(head), M, N)
    kw = dict(max_objects=K, max_parts=P, conf_thresh=0.3, dist_thresh=0.2)
    a = decode_feature_maps(outputs, nms_fn=sigmoid_nms, **kw)
    b = decode_feature_maps(outputs, **kw)
    for key in a:
        assert torch.equal(a[key], b[key]), key
