"""Kernels B and C: fused clamped sigmoid + 5x5 plateau NMS + top-k per
plane.

The port of `structuredetector_tpu/ops/pallas/topk.py::
fused_sigmoid_nms_topk`, with its two variants:

- "rounds" (the default), kernel B (`csrc/sigmoid_nms_topk.cu`): an
  exact two-phase selection. Phase 1 runs the tiled front of kernel A
  (`csrc/sigmoid_nms_front.cuh`) and writes each tile's best
  min(k, pixels) keys, sorted, to a candidate buffer whose size the
  library gives; phase 2 merges the tiles' lists of each plane by rank.
  The name is the Pallas variant's: kernel B no longer runs rounds;
- "onehot", kernel C (`csrc/sigmoid_nms_topk_rowmax.cu`): one launch, a
  cluster of 8 blocks a plane. Each block runs the same tiled front on
  its share of the plane's tiles and keeps the suppressed values in its
  own shared memory; rank 0 holds a table of the maxima of 32-pixel runs
  of flat index, and one warp runs the k rounds over it (winning run,
  one read of that run, mask, repair of its entry). Every plane the
  wrapper accepts fits on chip: no scratch buffer.

Both compute one function, so both have one plain version: values and
flat indices y * W + x equal `select_topk(plateau_nms(clamped_sigmoid(x)))`,
ties go to the smaller flat index, and with fewer than k peaks the zeros
are taken in ascending index order.

A CPU tensor goes through `sigmoid_nms_topk_reference`; a CUDA tensor
launches the variant's kernel or raises.
"""

from __future__ import annotations

import torch

from ..tensor import select_topk
from ._build import load
from .nms import sigmoid_nms_reference

MAX_PLANE_PIXELS = 256 * 256  # a 1024x1024 input at stride 4
_VARIANTS = ("rounds", "onehot")


def sigmoid_nms_topk_reference(planes: torch.Tensor, k: int):
    """Plain PyTorch version over (N, H, W) logits -> (values (N, k)
    float32, flat indices (N, k) int32)."""
    n, h, w = planes.shape
    # (N, 1, H, W): max_pool2d reads a 3-D input of N = 0 as 0 channels
    sup = sigmoid_nms_reference(planes.unsqueeze(1))
    vals, inds = select_topk(sup.reshape(n, h * w), k)
    return vals, inds.to(torch.int32)


def sigmoid_nms_topk(planes: torch.Tensor, k: int, variant: str = "rounds"):
    """clamped sigmoid + 5x5 plateau NMS + top-k of each (H, W) plane of
    (N, H, W) float32 logits. Returns (values (N, k) float32, flat
    indices (N, k) int32). `variant` picks the kernel on a CUDA tensor:
    "rounds" (kernel B) or "onehot" (kernel C); the result is the same."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
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
    with torch.cuda.device(planes.device):
        if variant == "rounds":
            _launch_two_phase(planes, k, vals, inds)
        else:
            _launch_rowmax(planes, k, vals, inds)
    sigmoid_nms_topk.launches_by_variant[variant] += 1
    return vals, inds


def _launch_two_phase(planes, k, vals, inds) -> None:
    n, h, w = planes.shape
    lib = load("sigmoid_nms_topk")
    # the candidate buffer: the library knows its tiling; phase 1 writes
    # every slot
    cand = torch.empty((n, lib.sdnet_topk_candidate_slots(h, w, k)), dtype=torch.int64,
                       device=planes.device)
    err = lib.sdnet_sigmoid_nms_topk(
        planes.data_ptr(), cand.data_ptr(), vals.data_ptr(), inds.data_ptr(), n, h, w, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sigmoid_nms_topk (rounds) kernel launch failed: CUDA error {err}")


def _launch_rowmax(planes, k, vals, inds) -> None:
    n, h, w = planes.shape
    err = load("sigmoid_nms_topk_rowmax").sdnet_sigmoid_nms_topk_rowmax(
        planes.data_ptr(), vals.data_ptr(), inds.data_ptr(), n, h, w, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sigmoid_nms_topk (onehot) kernel launch failed: CUDA error {err}")


# launches of each variant's kernel
sigmoid_nms_topk.launches_by_variant = {v: 0 for v in _VARIANTS}
