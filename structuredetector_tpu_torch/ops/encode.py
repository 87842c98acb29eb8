"""Training-target encoding (Gaussian splatting) on the device.

The port of `structuredetector_tpu/ops/encode.py`, with NCHW heatmaps.
The host ships only the padded keypoint arrays of
`data.pipeline.flatten_annotation`; the train step renders the dense
targets of the whole batch here. Numerics are the reference's
(`transforms.py:121-208`):

- sigma = sigma_gauss * min(out_w, out_h) / 3,
- Gaussians centred at the floored grid coordinates, unnormalized
  exp(-(dx^2 + dy^2) / (2 sigma^2)), max-merged per class channel,
- flat index floor(y) * out_w + floor(x),
- sub-cell offset xy - floor(xy),
- embedding target owner_xy - part_xy in float grid units,
- every field of an invalid slot is 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tensor import gaussian_heatmap_max


class EncodedTargets(NamedTuple):
    anchor_hm: torch.Tensor  # (B, M, H, W)
    part_hm: torch.Tensor  # (B, N, H, W)
    anchor_inds: torch.Tensor  # (B, O) int32, flat y*W+x
    part_inds: torch.Tensor  # (B, P) int32
    anchor_offsets: torch.Tensor  # (B, O, 2)
    part_offsets: torch.Tensor  # (B, P, 2)
    embeddings: torch.Tensor  # (B, P, 2)
    anchor_mask: torch.Tensor  # (B, O) bool
    part_mask: torch.Tensor  # (B, P) bool


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None] if x.dim() == 3 else mask, x, torch.zeros_like(x))


def encode_targets(
    anchors_xy: torch.Tensor,  # (B, O, 2) float, grid coords (clipped, scaled)
    anchor_cls: torch.Tensor,  # (B, O) int label index
    anchor_mask: torch.Tensor,  # (B, O) bool
    parts_xy: torch.Tensor,  # (B, P, 2) float, grid coords
    part_kind: torch.Tensor,  # (B, P) int part-kind index
    part_owner_xy: torch.Tensor,  # (B, P, 2) float grid coords of the owner anchor
    part_mask: torch.Tensor,  # (B, P) bool
    *,
    out_h: int,
    out_w: int,
    n_labels: int,
    n_parts: int,
    sigma_gauss: float,
    dtype: torch.dtype = torch.float32,
) -> EncodedTargets:
    """Dense training targets of a batch (JAX `encode_targets`)."""
    b = anchors_xy.shape[0]
    device = anchors_xy.device
    sigma = sigma_gauss * min(out_w, out_h) / 3.0

    a_ix, a_iy = torch.floor(anchors_xy[..., 0]), torch.floor(anchors_xy[..., 1])
    p_ix, p_iy = torch.floor(parts_xy[..., 0]), torch.floor(parts_xy[..., 1])

    anchor_hm = gaussian_heatmap_max(
        torch.zeros((b, n_labels, out_h, out_w), dtype=dtype, device=device),
        a_ix, a_iy, anchor_cls, anchor_mask, sigma, n_labels,
    )
    part_hm = gaussian_heatmap_max(
        torch.zeros((b, n_parts, out_h, out_w), dtype=dtype, device=device),
        p_ix, p_iy, part_kind, part_mask, sigma, n_parts,
    )
    anchor_inds = _masked((a_iy * out_w + a_ix).to(torch.int32), anchor_mask)
    part_inds = _masked((p_iy * out_w + p_ix).to(torch.int32), part_mask)
    anchor_offsets = _masked(
        torch.stack((anchors_xy[..., 0] - a_ix, anchors_xy[..., 1] - a_iy), -1).to(dtype),
        anchor_mask)
    part_offsets = _masked(
        torch.stack((parts_xy[..., 0] - p_ix, parts_xy[..., 1] - p_iy), -1).to(dtype),
        part_mask)
    embeddings = _masked((part_owner_xy - parts_xy).to(dtype), part_mask)
    return EncodedTargets(anchor_hm, part_hm, anchor_inds, part_inds, anchor_offsets,
                          part_offsets, embeddings, anchor_mask, part_mask)
