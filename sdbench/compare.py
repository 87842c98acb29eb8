"""The comparisons that decide `correct`: the program's answers against the
plain reference's, reduced to a few numbers, each held to its limit.

Detections (the inference cells). The program's annotations
of an image, in network-input pixels, against the reference's maps of the
same frame in float32 (`reference.decode.maps`). Each keypoint the program
returned is matched to the cell of its class whose reference position
(cell + offset) and score lie nearest. Every cell takes part, not only the
reference's peaks: a bf16 head rounds neighbouring logits to one value, and
the plateau NMS then keeps both, a second detection one cell from the
first that float32 suppresses; it matches its own cell.

- `logit_miss`, `pos_miss`: the share of the matched keypoints whose
  logit, or position, lies farther from the reference cell's than a stated
  margin (`LOGIT_MARGIN`, `POS_MARGIN_PX`): a match rate within a margin.
  The logit of the program's score is taken back through the sigmoid: the
  top scores sit near 1, where the sigmoid flattens differences out. A
  mean or a widest gap reads bf16 and the int8 control within a factor of
  two to three of each other; the share beyond a margin set between the
  two separates them;
- `count_gap` (exact): the anchors the program kept must number at least
  the reference's top-K anchors whose logit lies above `EDGE_LOGIT` and at
  most those above -`EDGE_LOGIT`; left-out images or detections read high.

Which of these a cell compares, and the limits, are in its workload file.
The part-to-anchor linking is not compared: the int8 control moves no
part to another anchor, and bf16 moved one on one seed (PERF.md).

Training. Three steps of the program against the reference's on the same
batches from the same state: `loss_gap` (the first step's total loss,
relative: later steps carry Adam's rounding of near-zero gradients),
`grad_gap` (the first gradient's norm by leaf, against the larger of that
leaf's norm and the median leaf's, at the median leaf: the worst leaf is a
BatchNorm shift or scale whose gradient, a sum that nearly cancels, bf16
moves by a tenth or more on every seed, PERF.md), `update_gap` (the
parameters' change after three steps by leaf, the same way, at the worst
leaf; leaves whose reference gradient is under a thousandth of the median
leaf's are left out: Adam moves them by round-off alone), `head_gap` (the
first step's network output: the norm of its difference from the
reference's over the reference's norm) and `head_miss` (the share of that
output's elements farther from the reference's than `HEAD_MARGIN` times
the RMS of the reference's channel: a match rate within a margin). The
sums and norms move little under rounding, and a randomly initialized
network magnifies every rounding into its output: on them bf16 and a
lower precision read within 1.6-2.4x of each other. From a trained state
the share beyond the margin separates the two by 5x or more (PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

POS_SCALE_PX = 1.0  # matching cost: one pixel weighs as ...
SCORE_SCALE = 0.01  # ... a hundredth of score
# The stated margins of `logit_miss` and `pos_miss`: bf16 moves the
# logits by at most 0.07-0.11 and positions by at most 0.3-0.7 px, the
# program's int8 convolutions a sixth of the logits by more than 0.15
# (PERF.md, the readings).
LOGIT_MARGIN = 0.15
POS_MARGIN_PX = 1.0
# An anchor whose reference logit lies within this of 0 (the 0.5 threshold)
# may be kept by one side and dropped by the other: bf16 moves the top
# logits by at most 0.12, the int8 control by at most 0.73 (PERF.md).
EDGE_LOGIT = 1.0
# The stated margin of `head_miss`: from a trained state, bf16 moves at
# most 3.2 % of the first step's output elements by more than 5 % of their
# channel's RMS, the float8 control at least 14.7 % (PERF.md, the readings).
HEAD_MARGIN = 0.05


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One `Check` per limit; a number the run could not read is +inf."""
    return [Check(k, float(values.get(k, float("inf"))), float(v)) for k, v in limits.items()]


# An object as both sides give it: (class, x, y, score, [(kind, x, y, score)]),
# positions in network-input pixels.
Obj = tuple


def _match(maps, channel: int, x: float, y: float, s: float):
    """The cell of `channel` whose reference position and score lie nearest
    (x, y, s): (its flat index, position gap px, logit gap). The logit of
    the program's score is taken back through the sigmoid in float64, so
    near-saturated scores keep their differences."""
    dx, dy = maps.x - x, maps.y - y
    ds = maps.prob[channel] - s
    cost = (dx * dx + dy * dy) / POS_SCALE_PX ** 2 + (ds / SCORE_SCALE) ** 2
    i = int(torch.argmin(cost))
    s = min(max(float(s), 1e-6), 1.0 - 1e-6)
    logit = math.log(s) - math.log1p(-s)
    return (i, float(torch.hypot(dx.flatten()[i], dy.flatten()[i])),
            abs(logit - float(maps.logit[channel].flatten()[i])))


def detection_gaps(program: Sequence[List[Obj]], reference: Sequence, *,
                   n_labels: int) -> Dict[str, float]:
    """The detection numbers over images paired by position in the two lists
    (`reference` holds `reference.decode.Maps`)."""
    logit_err, pos_err = [], []
    count_gap = 0
    for objects, maps in zip(program, reference):
        top = maps.top_logit
        n_sure, n_maybe = int((top > EDGE_LOGIT).sum()), int((top > -EDGE_LOGIT).sum())
        count_gap = max(count_gap, n_sure - len(objects), len(objects) - n_maybe)
        for cls, ax, ay, a_score, _ in objects:
            _, dpos, dlogit = _match(maps, cls, ax, ay, a_score)
            pos_err.append(dpos)
            logit_err.append(dlogit)
        for _, _, _, _, parts in objects:
            for kind, px, py, p_score in parts:
                _, dpos, dlogit = _match(maps, n_labels + kind, px, py, p_score)
                pos_err.append(dpos)
                logit_err.append(dlogit)
    if len(program) != len(reference):
        count_gap = float("inf")

    def share_beyond(xs, margin):
        return sum(x > margin for x in xs) / len(xs) if xs else float("inf")

    return {"logit_miss": share_beyond(logit_err, LOGIT_MARGIN),
            "pos_miss": share_beyond(pos_err, POS_MARGIN_PX),
            "count_gap": float(count_gap)}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keys: Sequence[str]) -> List[float]:
    """Each leaf's gap of norms against the larger of its reference norm and
    the median leaf's."""
    ref_norms = {k: float(ref[k].float().norm()) for k in keys}
    median = float(torch.tensor(list(ref_norms.values())).median())
    return [abs(float(prog[k].float().norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
            for k in keys]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """`prog` and `ref`: {"losses": [per step {term: float}], "head": tensor,
    "grad": {leaf: tensor}, "delta": {leaf: tensor}}, the first step's
    output and gradient and the parameters' change after three steps."""
    p, r = prog["losses"], ref["losses"]
    total_p, total_r = sum(p[0].values()), sum(r[0].values())
    loss = abs(total_p - total_r) / max(abs(total_r), 1e-30)
    if len(p) != len(r) or not all(math.isfinite(x[k]) for x in p for k in x):
        loss = float("inf")
    keys = sorted(ref["grad"])
    grad_norms = torch.tensor([float(ref["grad"][k].float().norm()) for k in keys])
    floor = 1e-3 * float(grad_norms.median())
    moving = [k for k, n in zip(keys, grad_norms.tolist()) if n >= floor]
    head_p, head_r = prog["head"], ref["head"]
    head = miss = float("inf")
    if head_p is not None and head_p.shape == head_r.shape:
        diff = (head_p.float() - head_r).abs()
        head = float(diff.norm() / head_r.norm().clamp(min=1e-30))
        rms = head_r.pow(2).mean(dim=(0, 2, 3), keepdim=True).sqrt()
        miss = float((diff > HEAD_MARGIN * rms).float().mean())
    return {"loss_gap": loss, "head_gap": head, "head_miss": miss,
            "grad_gap": float(torch.tensor(_leaf_gaps(prog["grad"], ref["grad"], keys)).median()),
            "update_gap": max(_leaf_gaps(prog["delta"], ref["delta"], moving))}
