"""Host-side decoders: detection tensors -> `ImageAnnotation` objects.

The port of `structuredetector_tpu/data/decoders.py`:

- `Decoder`: the device phase is `ops.decode.decode_feature_maps` with
  kernel A (`ops.kernels.sigmoid_nms`) as its front, and the host phase
  keeps the reference's threshold and ordering semantics
  (`decoders.py:102-139`): parts grouped by argmin anchor index in top-k
  order, anchors kept iff score > conf (strict), everything rescaled
  from grid to input pixels. `return_metadata=True` also returns the
  sigmoid heatmaps, the raw top-k rows and the conf-filtered
  `raw_parts` the Evaluator's part metric reads (`decoders.py:141-177`).
- `ExportDecoder`: `Decoder` for an exported graph, whose sigmoid + NMS
  already ran inside it (reference `CoreMLDecoder`,
  `decoders.py:182-184`): no second front.
- `KeypointDecoder`: flat keypoints, no grouping (`decoders.py:345-423`).

Maps are NCHW, as the port's model emits them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from ..annotations import ImageAnnotation, Keypoint, Object
from ..ops.decode import decode_feature_maps
from ..ops.kernels import sigmoid_nms
from ..tracing import span


class Decoder:
    apply_sigmoid_nms = True

    def __init__(self, config):
        self.config = config
        self.label_map = config.r_labels
        self.part_map = config.r_parts
        self.anchor_name = config.anchor_name
        self.down_ratio = config.down_ratio
        self.max_objects = config.max_objects  # K
        self.max_parts = config.max_parts  # P

    def decode_arrays(self, outputs: Dict[str, torch.Tensor], conf_thresh: float,
                      dist_thresh: float, with_metadata: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """Device phase only: fixed-shape detection tensors."""
        return decode_feature_maps(
            outputs,
            max_objects=self.max_objects,
            max_parts=self.max_parts,
            conf_thresh=conf_thresh,
            dist_thresh=dist_thresh,
            apply_sigmoid_nms=self.apply_sigmoid_nms,
            nms_fn=sigmoid_nms,
            with_metadata=with_metadata,
        )

    def __call__(self, outputs, conf_thresh=None, dist_thresh=None,
                 return_metadata: bool = False):
        conf_thresh = (
            conf_thresh if conf_thresh is not None else self.config.conf_threshold
        )
        dist_thresh = (
            dist_thresh if dist_thresh is not None else self.config.decoder_dist_thresh
        )
        out_h, out_w = outputs["anchor_hm"].shape[2:]
        in_h, in_w = int(self.down_ratio * out_h), int(self.down_ratio * out_w)

        dec = self.decode_arrays(outputs, conf_thresh, dist_thresh,
                                 with_metadata=return_metadata)
        annotations, anchors, parts = self.fetch_and_materialize(
            dec, (out_h, out_w), conf_thresh
        )
        if not return_metadata:
            return annotations

        # conf-filtered raw (pre-grouping) parts, rescaled to input pixels
        # (decoders.py:143-159); keeps score >= conf (strict < skip),
        # where the anchors above keep score > conf
        raw_parts = []
        for b_i in range(anchors.shape[0]):
            raw_b = []
            for i in range(self.max_parts):
                p = parts[b_i, i]
                score = float(p[2])
                if score < conf_thresh:
                    continue
                kp = Keypoint(self.part_map[int(p[3])], float(p[0]), float(p[1]), score)
                raw_b.append(kp.resize((out_w, out_h), (in_w, in_h)))
            raw_parts.append(raw_b)

        return {
            "annotation": annotations,
            "anchor_hm_sig": dec["anchor_hm_sig"],
            "part_hm_sig": dec["part_hm_sig"],
            "embeddings": dec["embeddings"],
            "anchors": anchors,
            "parts": parts,
            "raw_parts": raw_parts,
            "raw_embeddings": outputs["embeddings"],
            "raw_offsets": outputs["offsets"],
        }

    def fetch_and_materialize(self, dec, out_hw, conf_thresh):
        """One device->host copy of the four decode tensors, then
        `materialize`. Returns (annotations, anchors, parts): the numpy
        arrays come along for the metadata path's raw_parts."""
        with span("sd.predict.fetch"):
            anchors, parts, part_parent, part_valid = (
                dec[k].cpu().numpy()
                for k in ("anchors", "parts", "part_parent", "part_valid")
            )
        with span("sd.predict.materialize"):
            annotations = self.materialize(
                anchors, parts, part_parent, part_valid, out_hw, conf_thresh
            )
        return annotations, anchors, parts

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


class ExportDecoder(Decoder):
    """For exported graphs with sigmoid + NMS fused in (JAX
    `decoders.py:199-203`): the maps it reads are already suppressed
    probabilities, so it runs no front and launches no kernel."""

    apply_sigmoid_nms = False


class KeypointDecoder:
    """Flat keypoint decode without part->anchor grouping
    (reference decoders.py:345-423): every anchor and part with score
    >= conf, rescaled to input pixels, per image."""

    def __init__(self, config):
        self._decoder = Decoder(config)
        self.config = config

    def __call__(self, outputs):
        cfg = self.config
        out_h, out_w = outputs["anchor_hm"].shape[2:]
        in_h, in_w = int(cfg.down_ratio * out_h), int(cfg.down_ratio * out_w)
        r_h, r_w = in_h / out_h, in_w / out_w

        dec = self._decoder.decode_arrays(
            outputs, cfg.conf_threshold, cfg.decoder_dist_thresh
        )
        anchors, parts = dec["anchors"].cpu().numpy(), dec["parts"].cpu().numpy()

        annotations = []
        for b_i in range(anchors.shape[0]):
            kps = []
            for a in anchors[b_i]:
                if float(a[2]) < cfg.conf_threshold:
                    continue
                kps.append(
                    Keypoint(cfg.r_labels[int(a[3])], float(a[0]) * r_w,
                             float(a[1]) * r_h, float(a[2]))
                )
            for p in parts[b_i]:
                if float(p[2]) < cfg.conf_threshold:
                    continue
                kps.append(
                    Keypoint(cfg.r_parts[int(p[3])], float(p[0]) * r_w,
                             float(p[1]) * r_h, float(p[2]))
                )
            annotations.append(kps)
        return annotations
