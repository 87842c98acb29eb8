"""The port's decode kernels on the CPU: their plain versions against
the JAX Pallas kernels in interpret mode. The CUDA kernels are held
against these plain versions on the card in tests/test_torch_port_cuda.py.

On the CPU a wrapper runs its plain version. XLA's and torch's CPU
sigmoids may differ by an ulp, so values compare at atol 1e-6;
indices and the suppression pattern compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.ops.pallas.nms import fused_sigmoid_nms
from structuredetector_tpu.ops.pallas.topk import fused_sigmoid_nms_topk
from structuredetector_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    sigmoid_nms,
    sigmoid_nms_topk,
)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _planes(x: np.ndarray) -> np.ndarray:
    b, h, w, c = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)).reshape(b * c, h, w))


def test_sigmoid_nms_matches_pallas(rng):
    x = rng.normal(0, 3, size=(2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(fused_sigmoid_nms(jnp.asarray(x), interpret=True))
    got = np.transpose(sigmoid_nms(_nchw(x)).numpy(), (0, 2, 3, 1))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sigmoid_nms_peaks_survive():
    x = np.full((1, 16, 16, 1), -10.0, np.float32)
    x[0, 5, 5, 0] = 4.0
    want = np.asarray(fused_sigmoid_nms(jnp.asarray(x), interpret=True))
    got = np.transpose(sigmoid_nms(_nchw(x)).numpy(), (0, 2, 3, 1))
    assert got[0, 5, 5, 0] == np.float32(1 / (1 + np.exp(-4.0)))
    assert got[0, 5, 6, 0] == 0.0  # neighbours suppressed
    assert got[0, 12, 12, 0] > 0  # a flat region: every pixel is its window max
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
@pytest.mark.parametrize(
    "shape,k",
    [
        ((3, 32, 48, 2), 12),
        ((4, 16, 16, 2), 5),
        ((1, 32, 32, 1), 40),  # k > peak count: zeros taken in ascending index
        ((2, 24, 40, 3), 7),
        ((5, 16, 16, 2), 6),
        ((25, 16, 16, 2), 4),
    ],
)
def test_sigmoid_nms_topk_matches_pallas(rng, shape, k, variant):
    """Each variant of the port (kernel B "rounds", kernel C "onehot";
    on the CPU both run the one plain version) against the same variant
    of the Pallas kernel."""
    x = rng.normal(0, 3, size=shape).astype(np.float32)
    x[0, 4:7, 4:7, 0] = 2.5  # a plateau exercises the tie order
    planes = _planes(x)
    want_v, want_i = fused_sigmoid_nms_topk(jnp.asarray(planes), k, interpret=True,
                                            variant=variant)
    got_v, got_i = sigmoid_nms_topk(torch.from_numpy(planes), k, variant=variant)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_sigmoid_nms_topk_tie_break_ascending(variant):
    """All-equal plane: every pixel is its own plateau peak, and the
    selection walks ascending flat indices at the shared value."""
    planes = np.zeros((1, 16, 16), np.float32)
    want_v, want_i = fused_sigmoid_nms_topk(jnp.asarray(planes), 5, interpret=True,
                                            variant=variant)
    got_v, got_i = sigmoid_nms_topk(torch.from_numpy(planes), 5, variant=variant)
    np.testing.assert_array_equal(got_i.numpy()[0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), 0.5, atol=1e-6)


def test_sigmoid_nms_topk_rejects_oversized_k():
    with pytest.raises(ValueError, match="exceeds plane size"):
        sigmoid_nms_topk(torch.zeros((1, 4, 4)), 17)
    with pytest.raises(ValueError, match="exceeds plane size"):
        fused_sigmoid_nms_topk(jnp.zeros((1, 4, 4)), 17, interpret=True)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_sigmoid_nms_topk_of_no_planes(variant):
    vals, inds = sigmoid_nms_topk(torch.zeros((0, 8, 8)), 3, variant=variant)
    assert vals.shape == inds.shape == (0, 3)
    assert vals.dtype == torch.float32 and inds.dtype == torch.int32


def test_unknown_topk_variant_raises():
    """Both packages refuse a variant they do not have, rather than
    running another kernel."""
    with pytest.raises(ValueError, match="unknown variant"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8)), 3, variant="bitonic")
    with pytest.raises(ValueError, match="unknown variant"):
        fused_sigmoid_nms_topk(jnp.zeros((1, 8, 8)), 3, interpret=True, variant="bitonic")


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError, match="float32"):
        sigmoid_nms(torch.zeros((1, 1, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="B, C, H, W"):
        sigmoid_nms(torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="N, H, W"):
        sigmoid_nms_topk(torch.zeros((1, 1, 8, 8)), 3)
    with pytest.raises(TypeError, match="float32"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8), dtype=torch.bfloat16), 3)
    head = torch.zeros((2, 7, 8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_nms(head[:, :2])  # a channel slice of a batched head
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_nms_topk(head[:, 2:3].reshape(2, 8, 8), 3)  # a strided view
    with pytest.raises(ValueError, match="256x256"):
        sigmoid_nms_topk(torch.zeros((1, 257, 256)), 3)
    with pytest.raises(ValueError, match="k must be"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8)), 0)


def test_cpu_wrappers_count_no_launches(rng):
    """A CPU tensor runs the plain version, which is not a kernel launch."""
    before = launch_counts()
    x = torch.from_numpy(rng.normal(0, 3, (2, 3, 16, 16)).astype(np.float32))
    sigmoid_nms(x)
    sigmoid_nms_topk(x.reshape(6, 16, 16), 4)
    sigmoid_nms_topk(x.reshape(6, 16, 16), 4, variant="onehot")
    assert launch_counts() == before


def test_launch_counts_name_every_kernel_and_reset():
    sigmoid_nms_topk.launches_by_variant["onehot"] += 3  # as three launches would
    assert launch_counts()["sigmoid_nms_topk_rowmax"] >= 3
    reset_launch_counts()
    assert launch_counts() == {"sigmoid_nms": 0, "sigmoid_nms_topk": 0,
                               "sigmoid_nms_topk_rowmax": 0}
