"""Host-side decoder: detection tensors -> `ImageAnnotation` objects.

The port of `structuredetector_tpu/data/decoders.py::Decoder`: the device
phase is `ops.decode.decode_feature_maps` with kernel A
(`ops.kernels.sigmoid_nms`) as its front, and the host phase keeps the
reference's threshold and ordering semantics (`decoders.py:102-139`):
parts grouped by argmin anchor index in top-k order, anchors kept iff
score > conf (strict), everything rescaled from grid to input pixels.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from ..annotations import ImageAnnotation, Keypoint, Object
from ..ops.decode import decode_feature_maps
from ..ops.kernels import sigmoid_nms


class Decoder:
    def __init__(self, config):
        self.config = config
        self.label_map = config.r_labels
        self.part_map = config.r_parts
        self.anchor_name = config.anchor_name
        self.down_ratio = config.down_ratio
        self.max_objects = config.max_objects  # K
        self.max_parts = config.max_parts  # P

    def decode_arrays(self, outputs: Dict[str, torch.Tensor], conf_thresh: float,
                      dist_thresh: float) -> Dict[str, torch.Tensor]:
        """Device phase only: fixed-shape detection tensors."""
        return decode_feature_maps(
            outputs,
            max_objects=self.max_objects,
            max_parts=self.max_parts,
            conf_thresh=conf_thresh,
            dist_thresh=dist_thresh,
            nms_fn=sigmoid_nms,
        )

    def __call__(self, outputs, conf_thresh=None, dist_thresh=None):
        conf_thresh = (
            conf_thresh if conf_thresh is not None else self.config.conf_threshold
        )
        dist_thresh = (
            dist_thresh if dist_thresh is not None else self.config.decoder_dist_thresh
        )
        dec = self.decode_arrays(outputs, conf_thresh, dist_thresh)
        out_hw = tuple(outputs["anchor_hm"].shape[2:])
        return self.fetch_and_materialize(dec, out_hw, conf_thresh)

    def fetch_and_materialize(self, dec, out_hw, conf_thresh):
        """One device->host copy of the four decode tensors, then
        `materialize`."""
        anchors, parts, part_parent, part_valid = (
            dec[k].cpu().numpy()
            for k in ("anchors", "parts", "part_parent", "part_valid")
        )
        return self.materialize(
            anchors, parts, part_parent, part_valid, out_hw, conf_thresh
        )

    def materialize(self, anchors, parts, part_parent, part_valid,
                    out_hw, conf_thresh):
        """Host phase: numpy detection arrays -> annotations."""
        out_h, out_w = out_hw
        in_h, in_w = int(self.down_ratio * out_h), int(self.down_ratio * out_w)

        annotations = []
        for b_i in range(anchors.shape[0]):
            part_list = defaultdict(list)
            image_annotation = ImageAnnotation(f"batch_{b_i}")

            # parts grouped by argmin anchor, in top-k order (decoders.py:108-112)
            for i in range(self.max_parts):
                if not part_valid[b_i, i]:
                    continue
                part_list[int(part_parent[b_i, i])].append(parts[b_i, i])

            # anchors kept iff score strictly above conf (decoders.py:114-137)
            for anchor_i in range(self.max_objects):
                a = anchors[b_i, anchor_i]
                score = float(a[2])
                if score <= conf_thresh:
                    continue
                kps = [
                    Keypoint(
                        kind=self.part_map[int(p[3])],
                        x=float(p[0]), y=float(p[1]), score=float(p[2]),
                    )
                    for p in part_list[anchor_i]
                ]
                anchor = Keypoint(
                    kind=self.anchor_name, x=float(a[0]), y=float(a[1]), score=score
                )
                obj = Object(name=self.label_map[int(a[3])], anchor=anchor, parts=kps)
                image_annotation.objects.append(obj)

            annotations.append(
                image_annotation.resize((out_w, out_h), (in_w, in_h))
            )
        return annotations
