"""Kernel A: fused clamped sigmoid + 5x5 plateau NMS (`csrc/sigmoid_nms.cu`).

The port of `structuredetector_tpu/ops/pallas/nms.py::fused_sigmoid_nms`.
The wrapper takes NCHW logits as the port's head emits them, so the
NHWC <-> plane transposes of the Pallas version have no counterpart.

A CPU tensor goes through `sigmoid_nms_reference`, the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..tensor import clamped_sigmoid, plateau_nms
from ._build import load

_MAX_PLANES = 65535  # gridDim.z


def sigmoid_nms_reference(heatmaps: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `plateau_nms(clamped_sigmoid(x))`."""
    return plateau_nms(clamped_sigmoid(heatmaps))


def sigmoid_nms(heatmaps: torch.Tensor) -> torch.Tensor:
    """clamped sigmoid + 5x5 plateau NMS of (B, C, H, W) float32 logits.
    Returns the same-shape suppressed probabilities (non-peaks zeroed)."""
    if heatmaps.dim() != 4:
        raise ValueError(f"expected (B, C, H, W) logits, got shape {tuple(heatmaps.shape)}")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"expected float32 logits, got {heatmaps.dtype}")
    if not heatmaps.is_contiguous():
        raise ValueError("sigmoid_nms needs contiguous NCHW logits")
    b, c, h, w = heatmaps.shape
    if b * c > _MAX_PLANES:
        raise ValueError(f"{b * c} planes exceed the kernel's limit of {_MAX_PLANES}")
    if heatmaps.device.type == "cpu":
        return sigmoid_nms_reference(heatmaps)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"sigmoid_nms runs on cpu or cuda, not {heatmaps.device}")
    out = torch.empty_like(heatmaps)
    if out.numel() == 0:
        return out
    lib = load("sigmoid_nms")
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdnet_sigmoid_nms(
            heatmaps.data_ptr(), out.data_ptr(), b * c, h, w, stream)
    if err:
        raise RuntimeError(f"sigmoid_nms kernel launch failed: CUDA error {err}")
    sigmoid_nms.launches += 1
    return out


sigmoid_nms.launches = 0
