"""Training losses.

The port of `structuredetector_tpu/ops/losses.py` (reference
`loss.py`), on the port's NCHW maps:

- heatmap loss: CenterNet's penalty-reduced focal loss or plain MSE on
  the clamped sigmoid of the anchor and part heatmaps, times `hm_weight`;
- offset loss: masked L1 on the shared 2-channel offset map, gathered
  at the anchor and at the part indices;
- embedding loss: masked L1 at the part indices.

Every reduction is float32 whatever the compute dtype. Each loss returns
(total, stats dict of 0-d tensors); nothing here waits for the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .encode import EncodedTargets
from .tensor import clamped_sigmoid, gather_features


def focal_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss (reference loss.py:91-117):
    negative weight (1 - t)^4, powers 2, normalized by the count of
    positive pixels; the negative sum alone when there is none."""
    pred, target = pred.float(), target.float()
    pos_inds = (target == 1.0).float()
    neg_inds = (target < 1.0).float()
    neg_weights = (1.0 - target) ** 4
    one_minus_pred = 1.0 - pred
    neg_loss = torch.sum(torch.log(one_minus_pred) * pred**2 * neg_weights * neg_inds)
    pos_loss = torch.sum(torch.log(pred) * one_minus_pred**2 * pos_inds)
    num_pos = torch.sum(pos_inds)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch `nn.MSELoss` (mean), the reference's default heatmap loss."""
    return torch.mean((pred.float() - target.float()) ** 2)


def masked_l1_loss(feat: torch.Tensor, target: torch.Tensor, inds: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """sum(|gathered - target| * mask) / count of valid keypoints; 0 when
    none is valid (reference L1Loss, loss.py:53-64). feat (B, 2, H, W),
    target (B, K, 2), inds and mask (B, K)."""
    m = mask.float()
    numel = torch.sum(m)
    preds = gather_features(feat, inds).float()
    total = torch.sum(torch.abs((preds - target.float()) * m[..., None]))
    return torch.where(numel == 0, torch.zeros_like(total),
                       total / torch.clamp(numel, min=1.0))


def _masked_pair(feat, target, inds, mask):
    preds = gather_features(feat, inds).float()
    m = mask[..., None].float() * torch.ones_like(preds)
    return preds * m, target.float() * m, m


def masked_smooth_l1_loss(feat: torch.Tensor, target: torch.Tensor, inds: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Huber (beta 1) on masked preds and targets, over the mask's element
    count + 1e-7 (reference SmoothL1Loss, loss.py:67-76)."""
    p, t, m = _masked_pair(feat, target, inds, mask)
    diff = torch.abs(p - t)
    loss = torch.sum(torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5))
    return loss / (torch.sum(m) + 1e-7)


def masked_l2_loss(feat: torch.Tensor, target: torch.Tensor, inds: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Squared masked residuals over the mask's element count + 1e-7
    (reference L2Loss, loss.py:79-88)."""
    p, t, m = _masked_pair(feat, target, inds, mask)
    return torch.sum((p - t) ** 2) / (torch.sum(m) + 1e-7)


def sdnet_loss(
    outputs: Dict[str, torch.Tensor],
    targets: EncodedTargets,
    *,
    hm_loss_fn: str = "mse",
    hm_weight: float = 1.0,
    offset_weight: float = 1e-3,
    embedding_weight: float = 1e-3,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite SDNet loss (reference Loss.forward, loss.py:17-50) on raw
    logits 'anchor_hm' (B, M, H, W), 'part_hm' (B, N, H, W), 'offsets' and
    'embeddings' (B, 2, H, W)."""
    hm = focal_loss if hm_loss_fn == "focal" else mse_loss
    anchor_hm = clamped_sigmoid(outputs["anchor_hm"].float())
    part_hm = clamped_sigmoid(outputs["part_hm"].float())

    hm_loss = hm_weight * (hm(anchor_hm, targets.anchor_hm) + hm(part_hm, targets.part_hm))
    offset_loss = offset_weight * (
        masked_l1_loss(outputs["offsets"], targets.anchor_offsets, targets.anchor_inds,
                       targets.anchor_mask)
        + masked_l1_loss(outputs["offsets"], targets.part_offsets, targets.part_inds,
                         targets.part_mask)
    )
    embedding_loss = embedding_weight * masked_l1_loss(
        outputs["embeddings"], targets.embeddings, targets.part_inds, targets.part_mask)
    total = hm_loss + offset_loss + embedding_loss
    return total, {"hm_loss": hm_loss, "offset_loss": offset_loss,
                   "embedding_loss": embedding_loss, "total_loss": total}
