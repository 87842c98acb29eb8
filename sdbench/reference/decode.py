"""The plain reference of SDNet's decode (laclouis5/StructureDetector
`src/sdnet/data/decoders.py:29-139`): clamped sigmoid, 5x5 plateau NMS,
per-class top-k then a global top-k, the offset and embedding gathers,
each part's origin (its position plus its embedding) linked to the nearest
anchor above the confidence threshold within `dist_thresh * min(H, W)`
grid cells, anchors kept iff their score is above the threshold.

Float32 on (B, M + N + 4, H, W) head logits: M anchor maps, N part maps,
2 offsets, 2 embeddings. Positions come out in network-input pixels
(grid x `down_ratio`), on the host. Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

EPS = 1e-6


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x).clamp(EPS, 1.0 - EPS)


def plateau_nms(p: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Keep a cell iff it equals the max of its window, zero the rest."""
    m = F.max_pool2d(p, window, stride=1, padding=window // 2)
    return torch.where(p == m, p, torch.zeros_like(p))


class Maps(NamedTuple):
    """One image's reference maps on the host, every cell of them: the
    logits and the clamped sigmoid of each heatmap (anchors first, then
    parts) and each cell's decoded position (network-input px); and the
    logits of the top-K anchors the decode ranks, above the threshold or
    below it."""

    logit: torch.Tensor  # (M + N, H, W)
    prob: torch.Tensor  # (M + N, H, W)
    x: torch.Tensor  # (H, W) px
    y: torch.Tensor
    top_logit: torch.Tensor  # (K,), -inf where the top K reach past the peaks


def _topk(sup: torch.Tensor, k: int):
    """Two-stage top-k of (C, H, W): per class, then over the C * k."""
    c, h, w = sup.shape
    vals, inds = torch.sort(sup.reshape(c, h * w), dim=1, descending=True, stable=True)
    vals, inds = vals[:, :k], inds[:, :k]
    v2, i2 = torch.sort(vals.reshape(-1), descending=True, stable=True)
    v2, i2 = v2[:k], i2[:k]
    flat = inds.reshape(-1)[i2]
    return v2, flat, torch.div(i2, k, rounding_mode="floor"), flat // w, flat % w


def decode(head: torch.Tensor, n_labels: int, n_parts: int, *, max_objects: int,
           max_parts: int, conf: float, dist_thresh: float, down: float = 4.0) -> list:
    """(B, M + N + 4, H, W) logits -> each image's objects
    [(class, x, y, score, [(kind, x, y, score), ...])], positions in
    network-input px, anchors in top-K order, parts in top-P order."""
    head = head.float()
    nb = n_labels + n_parts
    sup = plateau_nms(clamped_sigmoid(head[:, :nb]))
    offsets, emb = head[:, nb:nb + 2], head[:, nb + 2:nb + 4]
    h, w = head.shape[2:]
    radius = dist_thresh * min(h, w)
    out = []
    for b in range(head.shape[0]):
        a_sup, p_sup = sup[b, :n_labels], sup[b, n_labels:]
        off, em = offsets[b], emb[b]
        a_s, _, a_c, a_y, a_x = _topk(a_sup, max_objects)
        p_s, _, p_c, p_y, p_x = _topk(p_sup, max_parts)
        ax = a_x.float() + off[0, a_y, a_x]
        ay = a_y.float() + off[1, a_y, a_x]
        px = p_x.float() + off[0, p_y, p_x]
        py = p_y.float() + off[1, p_y, p_x]
        ox, oy = px + em[0, p_y, p_x], py + em[1, p_y, p_x]
        a_on, p_on = a_s > conf, p_s > conf
        dist = torch.hypot(ox[None, :] - ax[:, None], oy[None, :] - ay[:, None])
        dist = torch.where(a_on[:, None] & p_on[None, :], dist, torch.full_like(dist, float("inf")))
        dmin, parent = dist.min(dim=0)
        linked = dmin < radius
        a_s, a_c, ax, ay, a_on, p_s, p_c, px, py, linked, parent = (t.cpu() for t in (
            a_s, a_c, ax, ay, a_on, p_s, p_c, px, py, linked, parent))
        objects = []
        for i in range(max_objects):
            if not a_on[i]:
                continue
            parts = [(int(p_c[j]), float(px[j]) * down, float(py[j]) * down, float(p_s[j]))
                     for j in range(max_parts) if linked[j] and int(parent[j]) == i]
            objects.append((int(a_c[i]), float(ax[i]) * down, float(ay[i]) * down,
                            float(a_s[i]), parts))
        out.append(objects)
    return out


def maps(head: torch.Tensor, n_labels: int, *, max_objects: int,
         down: float = 4.0) -> List[Maps]:
    """(B, M + N + 4, H, W) logits -> one `Maps` an image, on the host."""
    head = head.float()
    nb = head.shape[1] - 4
    prob = clamped_sigmoid(head[:, :nb])
    sup = plateau_nms(prob)
    h, w = head.shape[2:]
    gy = torch.arange(h, device=head.device, dtype=torch.float32).view(h, 1)
    gx = torch.arange(w, device=head.device, dtype=torch.float32).view(1, w)
    out = []
    for b in range(head.shape[0]):
        px, py = gx + head[b, nb], gy + head[b, nb + 1]
        a_s, _, a_c, a_y, a_x = _topk(sup[b, :n_labels], max_objects)
        # a map with fewer than K peaks fills the top-K with suppressed cells
        top = torch.where(a_s > 0, head[b, :n_labels][a_c, a_y, a_x],
                          torch.full_like(a_s, -float("inf")))
        out.append(Maps(*(t.cpu() for t in (
            head[b, :nb], prob[b], px * down, py * down, top))))
    return out
