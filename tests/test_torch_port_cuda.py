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


@pytest.mark.cuda
def test_kernels_bit_exact_on_card():
    """Built from csrc/ with nvcc; each kernel equals its plain version
    bit for bit at the serving shapes, at a plane count that is not a
    multiple of 8, on an all-equal plane, on non-square planes and on a
    256x256 plane (the scratch-buffer path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(926354916)
    x = torch.from_numpy(rng.normal(0, 3, (32, 3, 128, 128)).astype(np.float32)).cuda()
    torch.testing.assert_close(sigmoid_nms(x), sigmoid_nms_reference(x), rtol=0, atol=0)
    cases = [((64, 128, 128), 20), ((32, 128, 128), 40), ((100, 128, 128), 20),
             ((3, 40, 72), 9), ((4, 256, 256), 40)]
    for shape, k in cases:
        planes = torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()
        got = sigmoid_nms_topk(planes, k)
        want = sigmoid_nms_topk_reference(planes, k)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    flat = torch.zeros((2, 128, 128), device="cuda")
    _, inds = sigmoid_nms_topk(flat, 40)
    assert inds.cpu().tolist() == [list(range(40))] * 2
