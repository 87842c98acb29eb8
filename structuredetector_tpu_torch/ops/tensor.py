"""Plain PyTorch decode ops on channels-first heatmaps.

The port of `structuredetector_tpu/ops/tensor.py`, laid out for the
port's NCHW model output: heatmaps are (B, C, H, W) and flat spatial
indices are y * W + x, as in the reference.

Ties break by ascending flat index in both top-k stages, as
`lax.top_k` and the JAX iterative top-k do. `torch.topk` does not
document its tie order, so selection here is a stable descending sort
followed by a slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP_EPS = 1e-6  # reference utils.py:361


def clamp_in_0_1(x: torch.Tensor) -> torch.Tensor:
    """x clamped to [1e-6, 1 - 1e-6] (JAX `ops/tensor.py:24-25`)."""
    return torch.clamp(x, CLAMP_EPS, 1.0 - CLAMP_EPS)


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-6, 1 - 1e-6] (reference utils.py:355-361)."""
    return clamp_in_0_1(torch.sigmoid(x))


def plateau_nms(heatmaps: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Keep a pixel iff it equals the max of its `window` x `window`
    neighbourhood, zero the rest. heatmaps: (B, C, H, W) or (N, H, W);
    `max_pool2d` pads with -inf, so cells outside the plane never win."""
    m = F.max_pool2d(heatmaps, window, stride=1, padding=window // 2)
    return torch.where(heatmaps == m, heatmaps, torch.zeros_like(heatmaps))


def select_topk(scores: torch.Tensor, k: int):
    """Top-k over the last axis, equal values in ascending index order.
    Returns (values, int64 indices)."""
    vals, inds = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], inds[..., :k]


def _topk_stage2(topk_scores: torch.Tensor, topk_inds: torch.Tensor, k: int, w: int):
    """Global top-k over the (C * k) stage-1 scores; the class is
    `flat_index // k` (reference utils.py:460). Inputs (B, C, k);
    returns (scores, inds, classes, ys, xs), each (B, k)."""
    b, c, _ = topk_scores.shape
    topk_inds = topk_inds.reshape(b, c * k).long()
    score, ind = select_topk(topk_scores.reshape(b, c * k), k)
    inds = topk_inds.gather(1, ind)
    return (
        score,
        inds,
        torch.div(ind, k, rounding_mode="floor").float(),
        torch.div(inds, w, rounding_mode="floor").float(),
        (inds % w).float(),
    )


def topk_per_class(scores: torch.Tensor, k: int):
    """Two-stage top-k (reference utils.py:447-467) over (B, C, H, W)
    scores: top-k per class over the H*W plane, then over the C*k
    survivors. Returns (scores, inds, classes, ys, xs), each (B, k)."""
    b, c, h, w = scores.shape
    vals, inds = select_topk(scores.reshape(b, c, h * w), k)
    return _topk_stage2(vals, inds, k, w)


def gather_features(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Per-pixel feature vectors at flat indices: feat (B, C, H, W),
    inds (B, N) -> (B, N, C)."""
    b, c = feat.shape[:2]
    flat = feat.reshape(b, c, -1)
    idx = inds.long()[:, None, :].expand(b, c, inds.shape[1])
    return flat.gather(2, idx).transpose(1, 2)


def gaussian_heatmap_max(
    heat: torch.Tensor,
    centers_x: torch.Tensor,
    centers_y: torch.Tensor,
    classes: torch.Tensor,
    mask: torch.Tensor,
    sigma: float,
    n_channels: int,
) -> torch.Tensor:
    """Unnormalized Gaussians max-merged per class channel
    (`structuredetector_tpu/ops/tensor.py:145-181`, NCHW).

    heat: (B, C, H, W) initial heatmaps (usually zeros); centers_*: (B, K)
    integer-valued grid coordinates (the reference splats at `int(x),
    int(y)`); classes: (B, K) channel index; mask: (B, K) validity.
    Returns `heat` max-merged with each valid keypoint's Gaussian."""
    b, c, h, w = heat.shape
    if c != n_channels:
        raise ValueError(f"heat has {c} channels, expected {n_channels}")
    ys = torch.arange(h, dtype=torch.float32, device=heat.device).view(1, 1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=heat.device).view(1, 1, 1, w)
    dx2 = (xs - centers_x[:, :, None, None].float()) ** 2
    dy2 = (ys - centers_y[:, :, None, None].float()) ** 2
    gauss = torch.exp(-(dx2 + dy2) / (2.0 * sigma**2))  # (B, K, H, W)
    gauss = gauss * mask[:, :, None, None]
    channels = [
        (gauss * (classes == ch)[:, :, None, None]).amax(dim=1) if gauss.shape[1]
        else gauss.new_zeros((b, h, w))
        for ch in range(n_channels)
    ]
    return torch.maximum(heat, torch.stack(channels, dim=1).to(heat.dtype))
