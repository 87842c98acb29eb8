"""Device-side decode: head output -> fixed-shape detection tensors.

The port of `structuredetector_tpu/ops/decode.py`. The spec is the
reference `Decoder.__call__` device phase
(`/root/reference/src/sdnet/data/decoders.py:29-100`):

  clamped sigmoid -> 5x5 plateau NMS -> two-stage top-k (K anchors /
  P parts) -> gather sub-pixel offsets and embeddings -> (B, K, P)
  part-origin <-> anchor distance matrix -> per-part argmin.

Maps are channels first, as the port's model emits them: a dict of
'anchor_hm' (B, M, H, W), 'part_hm' (B, N, H, W), 'offsets' and
'embeddings' (B, 2, H, W). Two fronts produce the same detections:

- `decode_feature_maps`: sigmoid + NMS over whole maps (kernel A,
  `ops.kernels.sigmoid_nms`, in the `Decoder`), then a plain top-k;
- `decode_feature_maps_planes`: the serving decode, sigmoid + NMS +
  per-plane top-k in one pass (kernel B, `ops.kernels.sigmoid_nms_topk`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .kernels import sigmoid_nms_topk
from .tensor import _topk_stage2, clamped_sigmoid, gather_features, plateau_nms, topk_per_class


def split_head_output(raw: torch.Tensor, n_labels: int, n_parts: int) -> Dict[str, torch.Tensor]:
    """Split the raw (B, M+N+4, H, W) head output into named maps
    (reference network.py:77-84)."""
    nb_hm = n_labels + n_parts
    return {
        "anchor_hm": raw[:, :n_labels],
        "part_hm": raw[:, n_labels:nb_hm],
        "offsets": raw[:, nb_hm : nb_hm + 2],
        "embeddings": raw[:, nb_hm + 2 : nb_hm + 4],
    }


def _detections_tail(
    anchor_xs, anchor_ys, anchor_scores, anchor_labels,
    part_xs, part_ys, part_scores, part_labels, part_embs,
    conf_thresh: float, dist_thresh: float, out_w: int, out_h: int,
) -> Dict[str, torch.Tensor]:
    """Stack detection rows and associate each part origin with its
    nearest anchor, with the reference's masking (decoders.py:78-100):
    sub-threshold part origins move to -1e6 and sub-threshold anchors to
    +1e6, so they never link. Inputs are (B, K) / (B, P) stage-2 tensors
    with the offsets already added to the coordinates."""
    anchors = torch.stack((anchor_xs, anchor_ys, anchor_scores, anchor_labels), dim=2)
    origin_xs = part_xs + part_embs[..., 0]
    origin_ys = part_ys + part_embs[..., 1]
    parts = torch.stack(
        (part_xs, part_ys, part_scores, part_labels, origin_xs, origin_ys), dim=2
    )

    part_on = (part_scores > conf_thresh).float()
    ori_xs = -1e6 * (1.0 - part_on) + part_on * origin_xs
    ori_ys = -1e6 * (1.0 - part_on) + part_on * origin_ys

    anchor_on = (anchor_scores > conf_thresh).float()
    pos_xs = 1e6 * (1.0 - anchor_on) + anchor_on * anchor_xs
    pos_ys = 1e6 * (1.0 - anchor_on) + anchor_on * anchor_ys

    anchor_pos = torch.stack((pos_xs, pos_ys), dim=-1)[:, :, None, :]  # (B, K, 1, 2)
    origins = torch.stack((ori_xs, ori_ys), dim=-1)[:, None, :, :]  # (B, 1, P, 2)
    distance = torch.sqrt(torch.sum((origins - anchor_pos) ** 2, dim=-1))  # (B, K, P)

    min_vals, part_parent = torch.min(distance, dim=1)  # first minimum, like argmin
    # the radius in float32, as the JAX decode computes it
    radius = float(np.float32(dist_thresh) * np.float32(min(out_w, out_h)))
    return {
        "anchors": anchors,
        "parts": parts,
        "part_parent": part_parent.to(torch.int32),
        "part_valid": min_vals < radius,
    }


def _gather_tail(outputs, anchor_sel, part_sel, conf_thresh, dist_thresh):
    """Offsets and embeddings at the selected pixels, then the tail."""
    out_h, out_w = outputs["anchor_hm"].shape[2:]
    offsets = outputs["offsets"].float()
    anchor_scores, anchor_inds, anchor_labels, anchor_ys, anchor_xs = anchor_sel
    part_scores, part_inds, part_labels, part_ys, part_xs = part_sel

    anchor_offs = gather_features(offsets, anchor_inds)
    part_offs = gather_features(offsets, part_inds)
    part_embs = gather_features(outputs["embeddings"].float(), part_inds)
    return _detections_tail(
        anchor_xs + anchor_offs[..., 0], anchor_ys + anchor_offs[..., 1],
        anchor_scores, anchor_labels,
        part_xs + part_offs[..., 0], part_ys + part_offs[..., 1],
        part_scores, part_labels, part_embs,
        conf_thresh, dist_thresh, out_w, out_h,
    )


def decode_feature_maps(
    outputs: Dict[str, torch.Tensor],
    *,
    max_objects: int,
    max_parts: int,
    conf_thresh: float,
    dist_thresh: float,
    nms_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Decode NCHW head maps into fixed-shape detection tensors.

    `nms_fn` replaces the plain sigmoid + NMS front (the `Decoder` passes
    kernel A, `ops.kernels.sigmoid_nms`); it takes contiguous float32
    (B, C, H, W) logits.

    Returns:
      anchors (B, K, 4): x, y, score, label   (grid coords)
      parts   (B, P, 6): x, y, score, label, origin_x, origin_y
      part_parent (B, P) int32: argmin anchor index per part
      part_valid  (B, P) bool: part linked to its parent
    """
    front = nms_fn if nms_fn is not None else lambda x: plateau_nms(clamped_sigmoid(x))
    anchor_hm = front(outputs["anchor_hm"].float().contiguous())
    part_hm = front(outputs["part_hm"].float().contiguous())
    return _gather_tail(
        outputs,
        topk_per_class(anchor_hm, max_objects),
        topk_per_class(part_hm, max_parts),
        conf_thresh, dist_thresh,
    )


def decode_feature_maps_planes(
    outputs: Dict[str, torch.Tensor],
    *,
    max_objects: int,
    max_parts: int,
    conf_thresh: float,
    dist_thresh: float,
) -> Dict[str, torch.Tensor]:
    """Serving decode: the same detections as `decode_feature_maps`,
    with sigmoid + NMS + per-class top-k fused into kernel B over the
    (B * C, H, W) plane view of each heatmap group. The counterpart of
    the JAX `decode_feature_maps_cfirst`; in NCHW the plane order is
    batch-major, so stage 2 needs no transpose."""

    def extract(hm, k):
        b, c, h, w = hm.shape
        # the slice of the head is not contiguous across the batch: this
        # copies it into the plane layout the kernel reads
        planes = hm.float().reshape(b * c, h, w).contiguous()
        vals, inds = sigmoid_nms_topk(planes, k)
        return _topk_stage2(vals.reshape(b, c, k), inds.reshape(b, c, k), k, w)

    return _gather_tail(
        outputs,
        extract(outputs["anchor_hm"], max_objects),
        extract(outputs["part_hm"], max_parts),
        conf_thresh, dist_thresh,
    )
