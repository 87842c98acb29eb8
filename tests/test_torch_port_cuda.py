"""The port's CUDA kernels against their plain versions, on the card.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda

Where CUDA is unavailable (the CPU test run) the tests skip.
"""

import numpy as np
import pytest
import torch

from structuredetector_tpu_torch.ops.kernels import (
    sigmoid_nms,
    sigmoid_nms_reference,
    sigmoid_nms_topk,
    sigmoid_nms_topk_reference,
)


def _logits(rng, *shape):
    return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()


def _edge_cases(rng):
    """(planes, k) on the card where the tiling of kernels A, B and C
    (32-wide, 64-tall tiles) has edges to get wrong: ragged tiles, a plateau
    across a tile border, k above a tile's pixels on a plane with one peak,
    a 256x256 plane and one of more than 32 tiles, a 1x1 plane; a
    saturated background with one peak, the select's plateau path; and
    thin planes (1x4096, 4096x1, 65536x1), on which a layout sized by rows
    or by 64x32 tiles breaks. 33x65 and 1x1 give kernel C clusters in
    which some blocks own no tile."""
    border = _logits(rng, 2, 128, 128)
    border[:, 60:68, 28:36] = 20.0  # clamps to 1 - 1e-6: one plateau over 4 tiles
    yy, xx = np.mgrid[0:128, 0:128]
    cone = (5.0 - np.hypot(yy - 70, xx - 40) / 20.0).astype(np.float32)
    saturated = torch.full((2, 128, 128), -20.0, device="cuda")  # clamps to 1e-6
    saturated[0, 10, 12] = saturated[1, 100, 70] = 2.0
    return [
        (saturated, 40),
        (_logits(rng, 3, 33, 65), 9),
        (_logits(rng, 3, 40, 72), 9),
        (border, 40),
        (torch.from_numpy(np.stack([cone, cone.T])).cuda(), 2100),
        (_logits(rng, 4, 256, 256), 40),
        (_logits(rng, 2, 65, 1008), 40),
        (_logits(rng, 3, 1, 1), 1),
        (_logits(rng, 2, 1, 4096), 40),
        (_logits(rng, 2, 4096, 1), 40),
        (_logits(rng, 1, 65536, 1), 40),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_kernels_bit_exact_on_card(variant):
    """Built from csrc/ with nvcc; each kernel equals its plain version
    bit for bit at the serving shapes, at a plane count that is not a
    multiple of 8, on an all-equal plane, on non-square planes, on a
    256x256 plane and on the tiling's edge cases. Both top-k variants,
    kernel B ("rounds") and kernel C ("onehot"), have one plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(926354916)
    x = _logits(rng, 32, 3, 128, 128)
    torch.testing.assert_close(sigmoid_nms(x), sigmoid_nms_reference(x), rtol=0, atol=0)
    cases = [((64, 128, 128), 20), ((32, 128, 128), 40), ((100, 128, 128), 20),
             ((3, 40, 72), 9), ((4, 256, 256), 40)]
    for planes, k in [(_logits(rng, *shape), k) for shape, k in cases] + _edge_cases(rng):
        got = sigmoid_nms_topk(planes, k, variant=variant)
        want = sigmoid_nms_topk_reference(planes, k)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    flat = torch.zeros((2, 128, 128), device="cuda")
    _, inds = sigmoid_nms_topk(flat, 40, variant=variant)
    assert inds.cpu().tolist() == [list(range(40))] * 2
    vals, inds = sigmoid_nms_topk(torch.zeros((0, 128, 128), device="cuda"), 20,
                                  variant=variant)
    assert vals.shape == inds.shape == (0, 20)
    # k = H * W: every peak, then every zero in ascending index, until
    # each row is spent
    planes = _logits(rng, 2, 40, 72)
    got = sigmoid_nms_topk(planes, 40 * 72, variant=variant)
    for g, w in zip(got, sigmoid_nms_topk_reference(planes, 40 * 72)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_sigmoid_nms_bit_exact_on_tile_edges():
    """Kernel A on the planes of the tiling's edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for planes, _ in _edge_cases(np.random.default_rng(7)):
        x = planes.unsqueeze(1)
        torch.testing.assert_close(sigmoid_nms(x), sigmoid_nms_reference(x), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "hwk,slots",
    [
        ((128, 128, 20), 8 * 20),  # 2 x 4 tiles of 64 x 32
        ((128, 128, 2100), 8 * 2048),  # k above a tile's pixels
        ((40, 72, 9), 3 * 9),
        ((33, 65, 33 * 65), 3 * 33 * 32),
        ((256, 256, 40), 32 * 40),
        ((65, 1008, 40), 64 * 40),  # more tiles than a warp has lanes
        ((1, 1, 1), 1),
    ],
)
def test_candidate_slots_on_card(hwk, slots):
    """Kernel B's candidate buffer a plane: tiles x min(k, pixels of a
    full tile), from the library that owns the tiling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from structuredetector_tpu_torch.ops.kernels._build import load

    assert load("sigmoid_nms_topk").sdnet_topk_candidate_slots(*hwk) == slots


@pytest.mark.cuda
def test_topk_variant_launch_counts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    before = dict(sigmoid_nms_topk.launches_by_variant)
    planes = torch.zeros((3, 16, 16), device="cuda")
    sigmoid_nms_topk(planes, 4, variant="onehot")
    sigmoid_nms_topk(planes, 4, variant="onehot")
    sigmoid_nms_topk(planes, 4)
    after = sigmoid_nms_topk.launches_by_variant
    assert after["onehot"] - before["onehot"] == 2
    assert after["rounds"] - before["rounds"] == 1


@pytest.mark.cuda
def test_rowmax_is_one_launch_a_call():
    """Kernel C is one kernel launch a call on every plane shape it takes,
    thin and partial clusters included: no scratch buffer, no second
    phase. Counted from a torch.profiler (CUPTI) trace of the card, as
    chip_smoke.kernel_trace reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    shapes = [((64, 128, 128), 20), ((4, 256, 256), 40), ((1, 65536, 1), 40),
              ((2, 1, 4096), 40), ((3, 33, 65), 9), ((3, 1, 1), 1)]
    inputs = [(_logits(rng, *shape), k) for shape, k in shapes]
    for x, k in inputs:
        sigmoid_nms_topk(x, k, variant="onehot")  # build and warm up
    torch.cuda.synchronize()
    for x, k in inputs:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                sigmoid_nms_topk(x, k, variant="onehot")
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 3, (tuple(x.shape), names)
        assert all("rowmax_topk_kernel" in name for name in names), names
