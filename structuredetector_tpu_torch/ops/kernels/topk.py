"""Kernel B: fused clamped sigmoid + 5x5 plateau NMS + top-k per plane
(`csrc/sigmoid_nms_topk.cu`).

The port of `structuredetector_tpu/ops/pallas/topk.py::
fused_sigmoid_nms_topk` (variant "rounds"). Values and flat indices
y * W + x equal `select_topk(plateau_nms(clamped_sigmoid(x)))`: ties go
to the smaller flat index, and with fewer than k peaks the zeros are
taken in ascending index order.

A CPU tensor goes through `sigmoid_nms_topk_reference`, the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..tensor import select_topk
from ._build import load
from .nms import sigmoid_nms_reference

MAX_PLANE_PIXELS = 256 * 256  # a 1024x1024 input at stride 4
# Dynamic shared memory a block may use on sm_90 is 227 KiB; the kernel
# needs 8 bytes a pixel (sigmoid + suppressed plane) and ~150 bytes of
# its own. Larger planes use a global scratch buffer instead.
_SHARED_BYTES = 227 * 1024 - 1024


def sigmoid_nms_topk_reference(planes: torch.Tensor, k: int):
    """Plain PyTorch version over (N, H, W) logits -> (values (N, k)
    float32, flat indices (N, k) int32)."""
    n = planes.shape[0]
    sup = sigmoid_nms_reference(planes)
    vals, inds = select_topk(sup.reshape(n, -1), k)
    return vals, inds.to(torch.int32)


def sigmoid_nms_topk(planes: torch.Tensor, k: int):
    """clamped sigmoid + 5x5 plateau NMS + top-k of each (H, W) plane of
    (N, H, W) float32 logits. Returns (values (N, k) float32, flat
    indices (N, k) int32)."""
    if planes.dim() != 3:
        raise ValueError(f"expected (N, H, W) logits, got shape {tuple(planes.shape)}")
    if planes.dtype != torch.float32:
        raise TypeError(f"expected float32 logits, got {planes.dtype}")
    n, h, w = planes.shape
    if k > h * w:
        raise ValueError(f"k={k} exceeds plane size {h}x{w}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not planes.is_contiguous():
        raise ValueError("sigmoid_nms_topk needs contiguous (N, H, W) logits")
    if h * w > MAX_PLANE_PIXELS:
        raise ValueError(
            f"plane {h}x{w} exceeds the kernel's limit of {MAX_PLANE_PIXELS} "
            "pixels (256x256, a 1024x1024 input)"
        )
    if planes.device.type == "cpu":
        return sigmoid_nms_topk_reference(planes, k)
    if planes.device.type != "cuda":
        raise ValueError(f"sigmoid_nms_topk runs on cpu or cuda, not {planes.device}")
    vals = torch.empty((n, k), dtype=torch.float32, device=planes.device)
    inds = torch.empty((n, k), dtype=torch.int32, device=planes.device)
    if n == 0:
        return vals, inds
    scratch = None
    if 8 * h * w > _SHARED_BYTES:
        scratch = torch.empty((n, 2, h * w), dtype=torch.float32, device=planes.device)
    lib = load("sigmoid_nms_topk")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdnet_sigmoid_nms_topk(
            planes.data_ptr(), vals.data_ptr(), inds.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n, h, w, k, stream)
    if err:
        raise RuntimeError(f"sigmoid_nms_topk kernel launch failed: CUDA error {err}")
    sigmoid_nms_topk.launches += 1
    return vals, inds


sigmoid_nms_topk.launches = 0
