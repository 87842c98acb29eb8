"""Evaluation engine: greedy-matching detection metrics.

The port's own copy of `structuredetector_tpu/evaluation/evaluator.py`
(numpy only; `rich` is imported inside the `pretty_print` methods alone,
so `scalar_summary` and `save_kps_csv` need no more than numpy).
`tests/test_torch_port_evaluate.py` holds it to the original counter by
counter. Matching semantics are the spec of the reference
(upstream StructureDetector `src/sdnet/model/evaluator.py`):

- `Evaluation` — tp/npos/ndet counters with precision/recall/F1/CSI and
  localization accuracy mean/stderr (`evaluator.py:13-122`); F1 is
  2*tp/(npos+ndet) and CSI is tp/(npos+ndet-tp).
- `Evaluations` — per-label map with `+`, `|` union-merge and micro-
  average `reduce()` (`evaluator.py:125-205`).
- `Evaluator` — four metric families accumulated per image
  (`evaluator.py:226-242`):
  * anchor localization: score-sorted greedy matching of predicted
    anchors to the nearest GT within `dist_threshold * min(img_size)`
    with visited flags (`eval_anchor`, :244-284),
  * part localization on *raw* pre-grouping part detections
    (`eval_part`, :286-334),
  * CSI: per-object structural score (`compute_csi`, :538-581), object
    counts as TP iff csi >= csi_threshold (`eval_csi`, :380-420),
  * classification: objects bucketed by "{label}_{nb_parts}"
    (`eval_classif`, :429-474).

Implementation is redesigned for throughput: instead of deep-copying and
resizing annotation object graphs per metric family (the reference
resizes both annotations up front, `evaluator.py:246-248`), coordinates
are extracted once into numpy arrays already scaled to original image
space, and each greedy pass computes its full distance matrix in one
vectorized `np.hypot`. The greedy tie-breaking is preserved exactly:
stable descending score order, first-minimum wins.

Documented divergences:
- classification label space is derived as {label}_{0..9} for the
  configured labels instead of the reference's hardcoded bean_/maize_
  list (`evaluator.py:422-427`) — identical for the reference's labels;
- `Evaluations.__ior__` here is a working in-place union-merge; the
  reference's (`evaluator.py:180-185`) recursively `|=`'s plain dicts
  and raises AttributeError if ever called.
"""

from __future__ import annotations

import math
from copy import copy
from functools import reduce
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..annotations import dict_grouping

PART_COUNT_BUCKETS = 10  # bean_0..9 (evaluator.py:425)


class Evaluation:
    def __init__(self, tp=0, npos=0, ndet=0, acc=None, counts=None):
        Evaluation._precondition(tp, npos, ndet)
        self.tp = tp
        self.npos = npos
        self.ndet = ndet
        self.acc: List[float] = acc or []
        self.count_errors: list = counts or []

    def reset(self):
        self.__init__()

    def __iadd__(self, other: "Evaluation"):
        self.tp += other.tp
        self.npos += other.npos
        self.ndet += other.ndet
        self.acc = self.acc + other.acc
        self.count_errors = self.count_errors + other.count_errors
        return self

    def __add__(self, other: "Evaluation"):
        out = copy(self)
        out.acc = list(self.acc)
        out.count_errors = list(self.count_errors)
        out += other
        return out

    @property
    def fp(self):
        return self.ndet - self.tp

    @property
    def fn(self):
        return self.npos - self.tp

    @property
    def csi(self):
        d = self.npos + self.ndet - self.tp
        return self.tp / d if d != 0 else 1

    @property
    def precision(self):
        return self.tp / self.ndet if self.ndet != 0 else 1 if self.npos == 0 else 0

    @property
    def recall(self):
        return self.tp / self.npos if self.npos != 0 else 1 if self.ndet == 0 else 0

    @property
    def f1_score(self):
        s = self.npos + self.ndet
        return 2 * self.tp / s if s != 0 else 1

    @property
    def avg_acc(self):
        return float(np.mean(self.acc)) if self.acc else float("nan")

    @property
    def acc_err(self):
        return (
            float(np.std(self.acc) / np.sqrt(len(self.acc)))
            if self.acc
            else float("nan")
        )

    def stats(self):
        return (
            f"{self.npos}",
            f"{self.ndet}",
            f"{self.recall:.2%}",
            f"{self.precision:.2%}",
            f"{self.f1_score:.2%}",
            f"{self.avg_acc:.4%}",
            f"{self.acc_err:.4%}",
        )

    @staticmethod
    def columns():
        from rich.table import Column

        return (
            Column("GT", justify="right"),
            Column("Det", justify="right"),
            Column("Recall", justify="right"),
            Column("Precision", justify="right"),
            Column("F1", justify="right", style="green"),
            Column("Loc. acc", justify="right"),
            Column("± err", justify="right"),
        )

    def pretty_print(self):
        from rich import print as rprint
        from rich.table import Table

        table = Table(*Evaluation.columns())
        table.add_row(*self.stats())
        rprint(table)

    def save_conf_matrix(self, save_dir="."):
        """Per-label part-count confusion matrices -> conf_mat_<label>.npy
        (evaluator.py:108-114)."""
        by_label = dict_grouping(self.count_errors, lambda t: t[0])
        for label, errs in by_label.items():
            conf = np.zeros((PART_COUNT_BUCKETS, PART_COUNT_BUCKETS))
            for _, p, e in errs:
                # clamp into the 0..9 bucket space: the strict variant
                # records raw GT part counts (an 11-leaf object would
                # IndexError), and the reference's classification space
                # itself caps at 9 (evaluator.py:422-427)
                conf[min(e, PART_COUNT_BUCKETS - 1),
                     min(p, PART_COUNT_BUCKETS - 1)] += 1
            np.save(Path(save_dir) / f"conf_mat_{label}.npy", conf)

    def __repr__(self):
        return (
            f"Evaluation(f1={self.f1_score:.2%} rec={self.recall:.2%} "
            f"prec={self.precision:.2%} tp={self.tp} fp={self.fp} fn={self.fn} "
            f"npos={self.npos} ndet={self.ndet} loc_acc={self.avg_acc:.2})"
        )

    @staticmethod
    def _precondition(tp, npos, ndet):
        assert tp >= 0 and ndet >= 0 and npos >= 0, "counters cannot go negative"
        assert tp <= ndet, "true positives cannot exceed the detection count"
        assert tp <= npos, "true positives cannot exceed the ground-truth count"


class Evaluations:
    def __init__(self, labels=None):
        self.evals: Dict[str, Evaluation] = (
            {label: Evaluation() for label in labels} if labels else {}
        )

    def reset(self):
        for label in self.evals:
            self.evals[label].reset()

    @property
    def labels(self):
        return self.evals.keys()

    def items(self):
        return self.evals.items()

    def __getitem__(self, label):
        return self.evals[label]

    def __setitem__(self, label, item):
        self.evals[label] = item

    def __len__(self):
        return len(self.evals)

    def __add__(self, other: "Evaluations"):
        assert self.labels == other.labels, "cannot merge: label sets differ"
        out = Evaluations()
        out.evals = {label: self.evals[label] + e for label, e in other.items()}
        return out

    def __iadd__(self, other: "Evaluations"):
        assert self.labels == other.labels, "cannot merge: label sets differ"
        for label, e in other.items():
            self.evals[label] += e
        return self

    def __or__(self, other: "Evaluations"):
        """Union-merge: shared labels summed, exclusive labels kept
        (evaluator.py:167-178)."""
        out = Evaluations()
        out.evals = {
            label: self[label] + other[label] for label in self.labels & other.labels
        }
        out.evals.update({label: self[label] for label in self.labels - other.labels})
        out.evals.update({label: other[label] for label in other.labels - self.labels})
        return out

    def __ior__(self, other: "Evaluations"):
        """In-place union-merge. (The reference's `__ior__`,
        evaluator.py:180-185, `|=`'s plain dicts and would raise; this is
        the working equivalent of `self = self | other`.)"""
        for label in other.labels:
            if label in self.evals:
                self.evals[label] = self.evals[label] + other[label]
            else:
                self.evals[label] = other[label]
        return self

    def reduce(self) -> Evaluation:
        return reduce(Evaluation.__iadd__, self.evals.values(), Evaluation())

    def pretty_print(self, table_name=None):
        from rich import print as rprint
        from rich.table import Table

        table = Table("Label", *Evaluation.columns(), title=table_name)
        for label, e in self.items():
            table.add_row(label, *e.stats())
        if len(self) > 1:
            table.add_row("Total", *self.reduce().stats(), style="bold")
        rprint(table)

    def __repr__(self):
        desc = ""
        if len(self) > 1:
            desc += f"total: {self.reduce()}\n"
        desc += "\n".join(f"{label}: {e}" for label, e in self.items())
        return desc


# ---------------------------------------------------------------------------
# vectorized greedy matching core
# ---------------------------------------------------------------------------


def _xy_array(items, sx: float, sy: float) -> np.ndarray:
    """(n, 2) float64 coordinates scaled into original image space."""
    if not items:
        return np.empty((0, 2))
    out = np.empty((len(items), 2))
    for i, it in enumerate(items):
        out[i, 0] = it.x * sx
        out[i, 1] = it.y * sy
    return out


def _score_order(items) -> np.ndarray:
    """Stable descending-score order — same ordering as the reference's
    `sorted(key=score, reverse=True)`."""
    if not items:
        return np.empty((0,), np.intp)
    scores = np.array([it.score for it in items], dtype=float)
    return np.argsort(-scores, kind="stable")


def _greedy_match_xy(
    pred_xy: np.ndarray,
    order: np.ndarray,
    gt_xy: np.ndarray,
    dist_thresh: float,
    inclusive: bool = False,
) -> Tuple[int, List[float]]:
    """Greedy nearest matching with visited flags, vectorized.

    Each prediction (in `order`) is assigned its *globally* nearest GT
    (first minimum on ties, like the reference's strict `<` scan); it
    scores a TP iff that distance beats the threshold and the GT is
    unclaimed. Predictions whose nearest GT was already claimed get
    nothing — they do not fall back to the second-nearest (reference
    evaluator.py:269-283).

    Returns (tp, matched distances in match order).
    """
    if len(pred_xy) == 0 or len(gt_xy) == 0:
        return 0, []
    d = np.hypot(
        pred_xy[order, 0:1] - gt_xy[None, :, 0],
        pred_xy[order, 1:2] - gt_xy[None, :, 1],
    )  # (ndet, npos)
    j_min = d.argmin(axis=1)
    min_d = d[np.arange(len(order)), j_min]
    hit = (min_d <= dist_thresh) if inclusive else (min_d < dist_thresh)

    visited = np.zeros(len(gt_xy), bool)
    tp = 0
    acc: List[float] = []
    for i in range(len(order)):
        j = j_min[i]
        if hit[i] and not visited[j]:
            visited[j] = True
            tp += 1
            acc.append(float(min_d[i]))
    return tp, acc


class Evaluator:
    def __init__(self, config):
        self.config = config
        self.labels = list(config.labels.keys())
        self.kp_labels = list(config.parts.keys())
        self.reset()

    def reset(self):
        self.anchor_eval = Evaluations(self.labels)
        self.part_eval = Evaluations(self.kp_labels)
        self.csi_eval = Evaluations(self.labels)
        self.classification_eval = Evaluations(self.get_classification_labels())
        # part->parent assignment accuracy (no reference counterpart; the
        # direct probe for the structural-grouping path, see eval_grouping)
        self.grouping_correct = 0
        self.grouping_total = 0

    @property
    def kps_eval(self) -> Evaluations:
        return self.anchor_eval | self.part_eval

    def get_classification_labels(self):
        """{label}_{0..9} per configured label — generalizes the
        reference's hardcoded bean_/maize_ list (evaluator.py:422-427)."""
        return [
            f"{label}_{i}" for label in self.labels for i in range(PART_COUNT_BUCKETS)
        ]

    def accumulate(
        self,
        prediction,
        annotation,
        part_heatmap=None,
        eval_csi: bool = False,
        eval_classif: bool = False,
    ):
        """Accumulate one image (evaluator.py:226-242). `part_heatmap` is
        the decoder's raw (pre-grouping) conf-filtered part keypoints."""
        self.anchor_eval += self.eval_anchor(prediction, annotation)
        if part_heatmap is not None:
            self.part_eval += self.eval_part(annotation, part_heatmap)
        if eval_csi:
            self.csi_eval += self.eval_csi(prediction, annotation)
        if eval_classif:
            self.classification_eval += self.eval_classif(prediction, annotation)
        correct, total = self.eval_grouping(prediction, annotation)
        self.grouping_correct += correct
        self.grouping_total += total

    # -- metric families ------------------------------------------------

    def _scales(self, annotation):
        """Scale factors net-input -> original image, plus the matching
        threshold in image pixels (evaluator.py:246-249)."""
        img_w, img_h = annotation.img_size
        sx = img_w / self.config.width
        sy = img_h / self.config.height
        dist_thresh = min(annotation.img_size) * self.config.dist_threshold
        return sx, sy, dist_thresh, min(annotation.img_size)

    def eval_anchor(self, prediction, annotation) -> Evaluations:
        sx, sy, dist_thresh, norm = self._scales(annotation)
        preds = dict_grouping(prediction.objects, key=lambda o: o.name)
        gts = dict_grouping(annotation.objects, key=lambda o: o.name)

        result = Evaluations(self.labels)
        for label in self.labels:
            res = result[label]
            p, g = preds.get(label, []), gts.get(label, [])
            res.ndet, res.npos = len(p), len(g)
            tp, acc = _greedy_match_xy(
                _xy_array([o.anchor for o in p], sx, sy),
                _score_order([o.anchor for o in p]),
                _xy_array([o.anchor for o in g], sx, sy),
                dist_thresh,
            )
            res.tp = tp
            res.acc = [d / norm for d in acc]
        return result

    def eval_part(self, annotation, part_heatmap) -> Evaluations:
        """Part localization on raw pre-grouping detections
        (evaluator.py:286-334)."""
        sx, sy, dist_thresh, norm = self._scales(annotation)
        preds = dict_grouping(part_heatmap, key=lambda kp: kp.kind)
        gts = dict_grouping(
            (kp for obj in annotation.objects for kp in obj.parts),
            key=lambda kp: kp.kind,
        )

        result = Evaluations(self.kp_labels)
        for label in self.kp_labels:
            res = result[label]
            p, g = preds.get(label, []), gts.get(label, [])
            res.ndet, res.npos = len(p), len(g)
            tp, acc = _greedy_match_xy(
                _xy_array(p, sx, sy),
                _score_order(p),
                _xy_array(g, sx, sy),
                dist_thresh,
            )
            res.tp = tp
            res.acc = [d / norm for d in acc]
        return result

    def eval_part_grouped(self, prediction, annotation) -> Evaluations:
        """Variant using only parts that survived grouping (the
        reference's disabled `eval_part_2`, evaluator.py:336-378)."""
        sx, sy, dist_thresh, norm = self._scales(annotation)
        preds = dict_grouping(
            (p for o in prediction.objects for p in o.parts), key=lambda p: p.kind
        )
        gts = dict_grouping(
            (p for o in annotation.objects for p in o.parts), key=lambda p: p.kind
        )
        result = Evaluations(self.kp_labels)
        for label in self.kp_labels:
            res = result[label]
            p, g = preds.get(label, []), gts.get(label, [])
            res.ndet, res.npos = len(p), len(g)
            tp, acc = _greedy_match_xy(
                _xy_array(p, sx, sy),
                _score_order(p),
                _xy_array(g, sx, sy),
                dist_thresh,
            )
            res.tp = tp
            res.acc = [d / norm for d in acc]
        return result

    @staticmethod
    def _object_arrays(obj, sx: float, sy: float):
        """Pre-extract one object's matching data: scaled anchor position
        and per-kind part coordinate tuples in stable descending-score
        order (score order only matters for predictions). Plain tuples,
        not ndarrays — per-kind part lists are tiny (<= max_parts per
        object, usually a handful) and the CSI inner loop runs faster in
        pure Python than through numpy dispatch."""
        by_kind = dict_grouping(obj.parts, key=lambda kp: kp.kind)
        parts = {}
        for kind, kps in by_kind.items():
            if kps and kps[0].score is not None:
                kps = sorted(kps, key=lambda kp: kp.score, reverse=True)
            parts[kind] = [(kp.x * sx, kp.y * sy) for kp in kps]
        return obj.name, (obj.x * sx, obj.y * sy), parts

    @staticmethod
    def _csi_pair(pred_data, gt_data, dist_thresh) -> float:
        """CSI of one prediction/GT object pair from pre-extracted data
        (semantics of reference compute_csi, evaluator.py:538-581)."""
        pred_name, pred_anchor, pred_parts = pred_data
        gt_name, gt_anchor, gt_parts = gt_data
        if pred_name != gt_name:
            return 0.0

        npos = ndet = 1
        tp = int(
            math.hypot(pred_anchor[0] - gt_anchor[0], pred_anchor[1] - gt_anchor[1])
            < dist_thresh
        )

        for kind in gt_parts.keys() | pred_parts.keys():
            p = pred_parts.get(kind, ())
            g = gt_parts.get(kind, ())
            npos += len(g)
            ndet += len(p)
            if not p or not g:
                continue
            # greedy scan, first minimum wins (reference evaluator.py:559-576)
            visited = [False] * len(g)
            for px, py in p:
                min_d = math.inf
                j_min = -1
                for j, (gx, gy) in enumerate(g):
                    d = math.hypot(px - gx, py - gy)
                    if d < min_d:
                        min_d = d
                        j_min = j
                if min_d < dist_thresh and not visited[j_min]:
                    visited[j_min] = True
                    tp += 1

        d = npos + ndet - tp
        return tp / d if d != 0 else 1

    @staticmethod
    def compute_csi(prediction, target, dist_thresh) -> float:
        """Structural CSI of one predicted/GT object pair
        (evaluator.py:538-581): anchor counts 1/1, then per-kind greedy
        part matching; csi = tp / (npos + ndet - tp)."""
        return Evaluator._csi_pair(
            Evaluator._object_arrays(prediction, 1.0, 1.0),
            Evaluator._object_arrays(target, 1.0, 1.0),
            dist_thresh,
        )

    def eval_csi(self, prediction, annotation) -> Evaluations:
        """Object-level structural CSI (evaluator.py:380-420): greedy by
        best per-pair CSI (strict >, so the first maximum wins), TP iff
        best >= csi_threshold."""
        sx, sy, dist_thresh, _ = self._scales(annotation)
        preds = dict_grouping(prediction.objects, key=lambda o: o.name)
        gts = dict_grouping(annotation.objects, key=lambda o: o.name)

        result = Evaluations(self.labels)
        for label in self.labels:
            res = result[label]
            preds_label = preds.get(label, [])
            gts_label = gts.get(label, [])
            res.ndet = len(preds_label)
            res.npos = len(gts_label)

            order = _score_order([o.anchor for o in preds_label])
            pred_data = [
                self._object_arrays(preds_label[i], sx, sy) for i in order
            ]
            gt_data = [self._object_arrays(g, sx, sy) for g in gts_label]

            visited = [False] * len(gts_label)
            for pred in pred_data:
                best_csi = 0.0
                idx_best = None
                for j, gt in enumerate(gt_data):
                    csi = self._csi_pair(pred, gt, dist_thresh)
                    if csi > best_csi:
                        best_csi = csi
                        idx_best = j
                if (
                    idx_best is not None
                    and best_csi >= self.config.csi_threshold
                    and not visited[idx_best]
                ):
                    visited[idx_best] = True
                    res.tp += 1
                    res.acc.append(best_csi)
        return result

    def eval_grouping(self, prediction, annotation) -> Tuple[int, int]:
        """Direct part->parent assignment accuracy (no reference
        counterpart — added as the structural-grouping probe the CSI
        family can't localize; cf. reference evaluator.py:538-581 which
        only scores whole objects).

        For every part of every *predicted* object, find the nearest GT
        part of the same kind within the matching threshold. Localization
        misses are not the grouping path's fault and are skipped; for the
        matched ones, the assignment is correct iff the predicted parent
        anchor lies within the threshold of the matched GT part's OWNER
        anchor. Returns (correct, total matched)."""
        sx, sy, dist_thresh, _ = self._scales(annotation)

        gt_xy_by_kind: Dict[str, List[Tuple[float, float]]] = {}
        gt_owner_by_kind: Dict[str, List[Tuple[float, float]]] = {}
        for obj in annotation.objects:
            for kp in obj.parts:
                gt_xy_by_kind.setdefault(kp.kind, []).append((kp.x * sx, kp.y * sy))
                gt_owner_by_kind.setdefault(kp.kind, []).append(
                    (obj.x * sx, obj.y * sy)
                )

        correct = total = 0
        for obj in prediction.objects:
            ax, ay = obj.x * sx, obj.y * sy
            for kp in obj.parts:
                gxy = gt_xy_by_kind.get(kp.kind)
                if not gxy:
                    continue
                px, py = kp.x * sx, kp.y * sy
                dists = [math.hypot(px - gx, py - gy) for gx, gy in gxy]
                j = min(range(len(dists)), key=dists.__getitem__)
                if dists[j] >= dist_thresh:
                    continue
                total += 1
                ox, oy = gt_owner_by_kind[kp.kind][j]
                if math.hypot(ax - ox, ay - oy) < dist_thresh:
                    correct += 1
        return correct, total

    @property
    def grouping_accuracy(self) -> float:
        return (
            self.grouping_correct / self.grouping_total
            if self.grouping_total
            else float("nan")
        )

    def eval_classif(self, prediction, annotation) -> Evaluations:
        """Composite-label classification: objects bucketed by
        "{label}_{nb_parts}" (evaluator.py:429-474). Matching is by anchor
        distance with an *inclusive* threshold — the reference uses <=
        here (evaluator.py:469) where every other family uses <."""
        sx, sy, dist_thresh, norm = self._scales(annotation)
        key = lambda o: f"{o.name}_{o.nb_parts}"
        preds = dict_grouping(prediction.objects, key=key)
        gts = dict_grouping(annotation.objects, key=key)

        labels = self.get_classification_labels()
        result = Evaluations(labels)
        for label in labels:
            res = result[label]
            p, g = preds.get(label, []), gts.get(label, [])
            res.ndet, res.npos = len(p), len(g)
            tp, acc = _greedy_match_xy(
                _xy_array([o.anchor for o in p], sx, sy),
                _score_order([o.anchor for o in p]),
                _xy_array([o.anchor for o in g], sx, sy),
                dist_thresh,
                inclusive=True,
            )
            res.tp = tp
            res.acc = [d / norm for d in acc]
        return result

    def eval_classif_strict(self, prediction, annotation) -> Evaluations:
        """Stricter classification variant (the reference's unused
        `eval_classif_2`, evaluator.py:476-536): match against *all* GT
        objects by distance regardless of bucket, require the label to
        agree, and record part-count confusion pairs in `count_errors`
        (feeding `Evaluation.save_conf_matrix`). TP only when the part
        count also agrees."""
        sx, sy, dist_thresh, norm = self._scales(annotation)
        key = lambda o: f"{o.name}_{o.nb_parts}"
        preds = dict_grouping(prediction.objects, key=key)
        gts_by_label = dict_grouping(annotation.objects, key=key)
        gts = annotation.objects
        gt_xy = _xy_array([o.anchor for o in gts], sx, sy)
        visited = [False] * len(gts)

        labels = self.get_classification_labels()
        result = Evaluations(labels)
        for label in labels:
            res = result[label]
            preds_label = preds.get(label, [])
            res.ndet = len(preds_label)
            res.npos = len(gts_by_label.get(label, []))

            order = _score_order([o.anchor for o in preds_label])
            if len(order) == 0 or len(gts) == 0:
                continue
            p_xy = _xy_array([o.anchor for o in preds_label], sx, sy)[order]
            d = np.hypot(
                p_xy[:, 0:1] - gt_xy[None, :, 0], p_xy[:, 1:2] - gt_xy[None, :, 1]
            )
            j_min = d.argmin(axis=1)
            min_d = d[np.arange(len(order)), j_min]

            for i, oi in enumerate(order):
                pred = preds_label[oi]
                idx_best = int(j_min[i])
                if min_d[i] > dist_thresh or visited[idx_best]:
                    continue
                if pred.name not in gts[idx_best].name:
                    continue
                if pred.nb_parts != gts[idx_best].nb_parts:
                    res.count_errors.append(
                        (pred.name, pred.nb_parts, gts[idx_best].nb_parts)
                    )
                    continue
                visited[idx_best] = True
                res.tp += 1
                res.acc.append(float(min_d[i]) / norm)
                res.count_errors.append(
                    (pred.name, pred.nb_parts, gts[idx_best].nb_parts)
                )
        return result

    # -- reporting ------------------------------------------------------

    def _result_tables(self):
        return {
            "Anchor Location": self.anchor_eval,
            "Part Location": self.part_eval,
            "All Kps Location": self.kps_eval,
            "CSI": self.csi_eval,
            "Classification": self.classification_eval,
        }

    def pretty_print(self):
        from rich import print as rprint
        from rich.table import Column, Table

        for title, evals in self._result_tables().items():
            table = Table(Column("Label", style="bold"), *Evaluation.columns(), title=title)
            for label, e in evals.items():
                table.add_row(label, *e.stats())
            if len(evals) > 1:
                table.add_row("Total", *evals.reduce().stats(), style="bold")
            rprint(table)
        if self.grouping_total:
            rprint(
                f"Part->parent grouping accuracy: "
                f"[bold]{self.grouping_accuracy:.2%}[/bold] "
                f"({self.grouping_correct}/{self.grouping_total} matched parts)"
            )

    def _csv_kps_str(self) -> str:
        """Per-kind keypoint metrics as CSV rows
        (label,recall,precision,f1,mean localization accuracy) — the
        reference's `--save_csv_eval` data format (evaluator.py:606-626)."""
        rows = []
        evals = self.kps_eval
        for label in sorted(evals.labels):
            e = evals[label]
            rows.append(
                f"{label},{e.recall},{e.precision},{e.f1_score},{e.avg_acc}"
            )
        return "\n".join(rows)

    def save_kps_csv(self, path: Path):
        Path(path).write_text(self._csv_kps_str())

    def scalar_summary(self) -> Dict[str, float]:
        """Flat metric dict for logging (the trainer's TB scalars,
        trainer.py:173-223)."""
        out = {}
        for name, evals in (
            ("anchor", self.anchor_eval),
            ("part", self.part_eval),
            ("kps", self.kps_eval),
            ("csi", self.csi_eval),
            ("classif", self.classification_eval),
        ):
            total = evals.reduce()
            out[f"{name}/f1_total"] = total.f1_score
            out[f"{name}/precision_total"] = total.precision
            out[f"{name}/recall_total"] = total.recall
            out[f"{name}/csi_total"] = total.csi
            if total.acc:  # avg_acc is nan (never None) with no matches
                out[f"{name}/acc_total"] = total.avg_acc
            # per-label scalars mirror the reference's per-label TB dicts
            # (trainer.py:240-255: precision/recall/f1 + loc accuracy)
            for label, e in evals.items():
                if e.npos or e.ndet:
                    out[f"{name}/f1_{label}"] = e.f1_score
                    out[f"{name}/precision_{label}"] = e.precision
                    out[f"{name}/recall_{label}"] = e.recall
                    if e.acc:
                        out[f"{name}/acc_{label}"] = e.avg_acc
        if self.grouping_total:
            out["grouping/accuracy"] = self.grouping_accuracy
        out["grouping/matched_parts"] = float(self.grouping_total)
        return out

    def __repr__(self):
        desc = ""
        for name, evals in self._result_tables().items():
            desc += f"{name}\n"
            if len(evals) > 1:
                desc += f"  total: {evals.reduce()}\n"
            for label, e in sorted(evals.items(), key=lambda t: t[0]):
                desc += f"  {label}: {e}\n"
        return desc
