"""Drawing utilities for `detect` overlays and debug images.

The port's own copy of `structuredetector_tpu/visualization.py`, which
mirrors upstream StructureDetector's `src/sdnet/utils/visualization.py`:
- `draw`: object skeletons — anchor dot + part dots + white connecting
  lines (`visualization.py:13-50`),
- `draw_heatmaps`: class-colored max-composite of heatmap channels
  (`visualization.py:53-90`),
- `draw_kp_and_emb`: raw top-k keypoints with embedding rays
  (`visualization.py:93-146`),
- `draw_embeddings`: dense embedding quiver, every 4th cell
  (`visualization.py:149-169`),
- `draw_keypoints`: flat keypoint dots (`visualization.py:172-193`).

Inputs are numpy arrays (HWC, one image) or PIL images; nothing here
touches the device, so callers copy tensors to the host first. Heatmaps
are (H, W, C): a caller with the port's NCHW maps transposes one image's
(C, H, W) slice.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

from .ops.device_augment import IMAGENET_MEAN, IMAGENET_STD


def un_normalize(image: np.ndarray) -> np.ndarray:
    """Invert ImageNet normalization; image (H, W, 3) float."""
    return image * IMAGENET_STD + IMAGENET_MEAN


def to_pil(image) -> Image.Image:
    if isinstance(image, Image.Image):
        return image.copy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255).astype(np.uint8)
    return Image.fromarray(arr)


def draw(image, annotation, config, unnorm_image: bool = True) -> Image.Image:
    """Render an annotation's skeletons on the image."""
    if not isinstance(image, Image.Image):
        arr = np.asarray(image, np.float32)
        img = to_pil(un_normalize(arr) if unnorm_image else arr)
    else:
        img = image.copy()

    d = ImageDraw.Draw(img)
    img_w, img_h = img.size
    offset = max(1, int(min(img_w, img_h) / 100))
    thickness = max(1, int(min(img_w, img_h) / 100))
    label_colors = config.label_color_map
    part_colors = config.part_color_map

    for obj in annotation.objects:
        obj_color = label_colors.get(obj.name, (255, 255, 255))
        x, y = obj.x, obj.y
        for kp in obj.parts:
            kp_color = part_colors.get(kp.kind, (255, 255, 255))
            d.line([x, y, kp.x, kp.y], fill="white", width=thickness)
            d.ellipse(
                [kp.x - offset, kp.y - offset, kp.x + offset, kp.y + offset],
                fill=kp_color, outline=kp_color,
            )
        d.ellipse(
            [x - offset, y - offset, x + offset, y + offset],
            fill=obj_color, outline=obj_color,
        )
    return img


def draw_heatmaps(anchor_hm: np.ndarray, part_hm: np.ndarray, config):
    """Color-composite (H, W, C) heatmaps -> two (H, W, 3) uint8 images
    (per-pixel argmax channel picks the label color, scaled by value)."""
    assert anchor_hm.ndim == 3 and part_hm.ndim == 3, "one sample only (H, W, C)"

    def composite(hm: np.ndarray, colors: np.ndarray) -> np.ndarray:
        max_val = hm.max(axis=-1)  # (H, W)
        idx = hm.argmax(axis=-1)  # (H, W)
        rgb = colors[idx].astype(np.float32) * max_val[..., None]
        return np.clip(rgb, 0, 255).astype(np.uint8)

    label_colors = np.array(
        [config.label_color_map.get(config.r_labels.get(i), (0, 0, 0))
         for i in range(anchor_hm.shape[-1])]
    )
    part_colors = np.array(
        [config.part_color_map.get(config.r_parts.get(i), (0, 0, 0))
         for i in range(part_hm.shape[-1])]
    )
    return composite(np.asarray(anchor_hm), label_colors), composite(
        np.asarray(part_hm), part_colors
    )


def draw_kp_and_emb(image, anchors: np.ndarray, parts: np.ndarray,
                    config) -> Image.Image:
    """Raw top-k detections with embedding rays. anchors (K, 4) rows
    x,y,score,label; parts (P, 6) rows x,y,score,label,origin_x,origin_y
    (grid coords)."""
    thresh = config.conf_threshold
    r = config.down_ratio
    img = to_pil(un_normalize(np.asarray(image, np.float32)))
    d = ImageDraw.Draw(img)
    img_w, img_h = img.size
    offset = max(1, int(min(img_w, img_h) / 100))
    thickness = max(1, int(min(img_w, img_h) / 100))

    for x, y, score, label in np.asarray(anchors):
        if score < thresh:
            continue
        color = config.label_color_map[config.r_labels[int(label)]]
        x, y = x * r, y * r
        d.ellipse([x - offset, y - offset, x + offset, y + offset],
                  fill=color, outline=color)

    for x, y, score, label, ox, oy in np.asarray(parts):
        if score < thresh:
            continue
        color = config.part_color_map[config.r_parts[int(label)]]
        x, y, ox, oy = x * r, y * r, ox * r, oy * r
        d.ellipse([x - offset, y - offset, x + offset, y + offset],
                  fill=color, outline=color)
        d.line([x, y, ox, oy], fill=color, width=thickness)
    return img


def draw_embeddings(image, embeddings: np.ndarray, config,
                    stride: int = 4) -> Image.Image:
    """Dense embedding field quiver; embeddings (H, W, 2) grid units."""
    emb = np.asarray(embeddings, np.float32) * config.down_ratio
    img = to_pil(un_normalize(np.asarray(image, np.float32)))
    d = ImageDraw.Draw(img)
    thickness = max(1, int(min(img.size) * 0.5 / 100))

    for y in range(0, emb.shape[0], stride):
        for x in range(0, emb.shape[1], stride):
            x1 = x * config.down_ratio
            y1 = y * config.down_ratio
            d.line([x1, y1, float(emb[y, x, 0] + x1), float(emb[y, x, 1] + y1)],
                   fill=(255, 0, 0), width=thickness)
    return img


def draw_keypoints(image, keypoints, config) -> Image.Image:
    """Flat keypoint dots in their label's or part's colour
    (`visualization.py:172-193`); a kind of neither raises ValueError."""
    img = to_pil(image)
    d = ImageDraw.Draw(img)
    img_w, img_h = img.size
    offset = max(1, int(min(img_w, img_h) / 100))
    for kp in keypoints:
        if kp.kind in config.labels:
            color = config.label_color_map[kp.kind]
        elif kp.kind in config.parts:
            color = config.part_color_map[kp.kind]
        else:
            raise ValueError(f"unknown keypoint kind {kp.kind!r}")
        d.ellipse([kp.x - offset, kp.y - offset, kp.x + offset, kp.y + offset],
                  fill=color, outline=color)
    return img
