"""High-level single-image / batch Predictor.

The port of `structuredetector_tpu/predictor.py`: load the model ->
transform -> forward -> decode -> `ImageAnnotation` in original image
coordinates. One forward serves both decode paths:

- the fast path (the default on CUDA): `decode_feature_maps_planes`,
  with sigmoid + NMS + per-plane top-k in kernel B;
- `fast_path=False`: the `Decoder`, with sigmoid + NMS in kernel A and a
  plain top-k.

Both give the same detections from the same head output. With
`config.int8` the forward runs the int8 convs (`models.quantize`).
`ExportPredictor` serves a `.sdz` artifact (`export.py`) instead of a
checkpoint.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .annotations import ImageAnnotation, Object
from .data.augment import PredictionTransformation
from .data.decoders import Decoder
from .models.network import init_model
from .models.weights import load_weights
from .ops.decode import decode_feature_maps_planes, split_head_output
from .ops.device_augment import normalize_images
from .tracing import span
from .utils import resolve_device


class PreparedImage(NamedTuple):
    """An already decoded and resized network input: skips the per-image
    PIL transform inside `predict_batch`. `array` is (net_h, net_w, 3)
    in the predictor's feed dtype (uint8 with device_normalize,
    normalized float32 otherwise); `size` is the original (w, h) the
    annotation is rescaled to."""

    array: np.ndarray
    size: Tuple[int, int]


def tile_grid(
    img_w: int, img_h: int, tile_w: int, tile_h: int, overlap: float = 0.25
) -> List[Tuple[int, int]]:
    """Top-left corners of a sliding-window grid covering (img_w, img_h)
    with tiles of (tile_w, tile_h) and at least `overlap` fraction of
    shared border between neighbours. The last tile of each axis snaps
    flush to the image edge, so coverage is exact without padding."""
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")

    def axis(size: int, tile: int) -> List[int]:
        if size <= tile:
            return [0]
        stride = max(1, int(tile * (1.0 - overlap)))
        xs = list(range(0, size - tile, stride))
        xs.append(size - tile)
        return xs

    return [(x, y) for y in axis(img_h, tile_h) for x in axis(img_w, tile_w)]


def merge_tiled_objects(objects: Sequence[Object], radius: float) -> List[Object]:
    """Cross-tile deduplication: a greedy pass over objects sorted by
    anchor score (desc); an object is dropped if a kept object of the
    same label has its anchor within `radius` pixels. Kept anchors index
    into a `radius`-sized grid, so each candidate checks only the 3x3
    neighbouring cells."""
    cell = max(radius, 1e-6)
    grid: dict = {}  # (cx, cy) -> list of kept Objects
    kept: List[Object] = []
    for obj in sorted(objects, key=lambda o: -(o.anchor.score or 0.0)):
        cx, cy = int(obj.anchor.x // cell), int(obj.anchor.y // cell)
        dup = any(
            k.name == obj.name
            and math.hypot(k.anchor.x - obj.anchor.x, k.anchor.y - obj.anchor.y)
            < radius
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for k in grid.get((cx + dx, cy + dy), ())
        )
        if not dup:
            kept.append(obj)
            grid.setdefault((cx, cy), []).append(obj)
    return kept


def _shift_object(obj: Object, dx: float, dy: float) -> Object:
    for kp in [obj.anchor, *obj.parts]:
        kp.x += dx
        kp.y += dy
    if obj.box is not None:
        obj.box.x_min += dx
        obj.box.x_max += dx
        obj.box.y_min += dy
        obj.box.y_max += dy
    return obj


def _as_rgb(image):
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.open(image)
    if image.mode != "RGB":
        image = image.convert("RGB")
    return image


def _prepare(images: Sequence, transform) -> Tuple[list, List[np.ndarray]]:
    """Per-image host prep of a batch -> (sources, network feeds): a
    `PreparedImage` goes as it is, anything else is opened as RGB and
    `transform`ed."""
    with span("sd.predict.prep"):
        sources, arrays = [], []
        for im in images:
            if isinstance(im, PreparedImage):
                sources.append(im)
                arrays.append(im.array)
                continue
            im = _as_rgb(im)
            sources.append(im)
            arrays.append(transform(im))
        return sources, arrays


def _stack_to_device(arrays, device: torch.device) -> torch.Tensor:
    with span("sd.predict.h2d"):
        batch = torch.from_numpy(arrays if isinstance(arrays, np.ndarray) else np.stack(arrays))
        if device.type == "cuda":
            # pinned + non_blocking: the copy queues behind earlier work
            # on the stream instead of blocking this thread on it
            return batch.pin_memory().to(device, non_blocking=True)
        return batch


class Predictor:
    def __init__(
        self,
        config,
        model_path: Optional[Path] = None,
        device="cuda",
        device_normalize: bool = True,
        fast_path: Optional[bool] = None,
    ):
        """`device` defaults to CUDA and raises where CUDA is missing;
        pass "cpu" explicitly to run there. `model_path` (or
        `config.pretrained_model`) is a `.pth` or a JAX `.msgpack`
        checkpoint.

        `device_normalize` (default): the host only resizes; uint8
        pixels go to the device and the /255 + ImageNet normalization
        runs there. False normalizes on the host in float32.

        `fast_path` (default: on iff the device is CUDA): decode through
        kernel B (`decode_feature_maps_planes`) instead of the `Decoder`
        (kernel A + plain top-k). Same forward, same detections."""
        self.config = config
        self.device = resolve_device(device)
        model = init_model(config)
        path = model_path or config.pretrained_model
        if path:
            load_weights(model, path)
        self.model = model.to(self.device)
        self.transform = PredictionTransformation(config, device_normalize=device_normalize)
        self.decoder = Decoder(config)
        if fast_path is None:
            fast_path = self.device.type == "cuda"
        self.fast_path = bool(fast_path)

    @property
    def feed_uint8(self) -> bool:
        """True when the network input is raw uint8 RGB (normalization
        runs on the device)."""
        return bool(self.transform.device_normalize)

    @property
    def feed_normalize(self) -> bool:
        """True when the host ImageNet-normalizes the float32 feed."""
        return not self.feed_uint8

    @torch.inference_mode()
    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) host feed on the device -> (B, M+N+4, H/4, W/4)
        float32 head output."""
        if self.feed_uint8:
            batch = normalize_images(batch.float() / 255.0)
        return self.model(batch.permute(0, 3, 1, 2).contiguous(), raw_output=True)

    @torch.inference_mode()
    def decode(self, head: torch.Tensor, fast_path: Optional[bool] = None):
        """Fixed-shape device decode of a head output -> detection dict."""
        cfg = self.config
        outputs = split_head_output(head, cfg.n_labels, cfg.n_parts)
        if fast_path is None:
            fast_path = self.fast_path
        if fast_path:
            return decode_feature_maps_planes(
                outputs,
                max_objects=cfg.max_objects,
                max_parts=cfg.max_parts,
                conf_thresh=cfg.conf_threshold,
                dist_thresh=cfg.decoder_dist_thresh,
            )
        return self.decoder.decode_arrays(
            outputs, cfg.conf_threshold, cfg.decoder_dist_thresh
        )

    def to_device(self, arrays) -> torch.Tensor:
        """Stack (H, W, 3) host feeds into one batch on the device; a
        (B, H, W, 3) array (a collated batch) goes as it is."""
        return _stack_to_device(arrays, self.device)

    def _device_decode(self, arrays: List[np.ndarray]):
        batch = self.to_device(arrays)
        with span("sd.predict.forward"):
            head = self.forward(batch)
        with span("sd.predict.decode"):
            return self.decode(head), tuple(head.shape[2:])

    def predict_image(self, image) -> ImageAnnotation:
        """One image -> annotation in original pixel coordinates."""
        return self.predict_batch([image])[0]

    def predict_batch(self, images: Sequence) -> List[ImageAnnotation]:
        return self.predict_batch_collect(self.predict_batch_submit(images))

    def predict_batch_submit(self, images: Sequence) -> Optional[tuple]:
        """Device half of `predict_batch`: prep + transfer + forward +
        fixed-shape decode, queued on the device without waiting for
        results. Returns a handle for `predict_batch_collect`; serving's
        depth-2 pipeline prepares batch N+1 while batch N runs."""
        if not images:
            return None
        with span("sd.predict.submit"):
            sources, arrays = _prepare(images, self.transform)
            dec, out_hw = self._device_decode(arrays)
        return dec, out_hw, sources

    def predict_batch_collect(self, handle) -> List[ImageAnnotation]:
        """Host half of `predict_batch`: fetch the decode tensors of a
        `predict_batch_submit` handle and build the annotations."""
        if handle is None:
            return []
        dec, out_hw, sources = handle
        with span("sd.predict.collect"):
            annotations, _, _ = self.decoder.fetch_and_materialize(
                dec, out_hw, self.config.conf_threshold
            )
            return _rescale(annotations, sources, self.config)

    def predict_tiled(
        self,
        image,
        overlap: float = 0.25,
        batch_size: int = 8,
        dedup_radius: Optional[float] = None,
    ) -> ImageAnnotation:
        """Sliding-window detection for images larger than the network
        input: crop network-sized tiles on a `tile_grid`, run them
        through the same forward + decode as `predict_batch`, shift
        detections into global pixel coordinates and merge cross-tile
        duplicates (`merge_tiled_objects`, higher anchor score wins
        within `dedup_radius`, default `dist_threshold * min(tile
        size)`). Tile batches are padded to a fixed `batch_size`."""
        image = _as_rgb(image)
        tw, th = self.config.width, self.config.height
        corners = tile_grid(image.width, image.height, tw, th, overlap)
        tiles = [image.crop((x, y, x + tw, y + th)) for x, y in corners]

        objects: List[Object] = []
        for start in range(0, len(tiles), batch_size):
            chunk = tiles[start : start + batch_size]
            n = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch_size - n)
            dec, out_hw = self._device_decode([self.transform(t) for t in chunk])
            anns, _, _ = self.decoder.fetch_and_materialize(
                dec, out_hw, self.config.conf_threshold
            )
            for ann, (x, y) in zip(anns[:n], corners[start : start + n]):
                objects.extend(_shift_object(o, x, y) for o in ann.objects)

        # an image smaller than the tile on an axis gets black crop
        # padding, where anchors can't be real objects; on a full-sized
        # axis an anchor regressed fractionally outside the border is
        # real and is clamped into bounds
        pad_x, pad_y = image.width < tw, image.height < th
        kept_objects: List[Object] = []
        for o in objects:
            if pad_x and not 0 <= o.anchor.x < image.width:
                continue
            if pad_y and not 0 <= o.anchor.y < image.height:
                continue
            o.anchor.x = min(max(o.anchor.x, 0.0), image.width - 1)
            o.anchor.y = min(max(o.anchor.y, 0.0), image.height - 1)
            kept_objects.append(o)

        radius = (
            dedup_radius
            if dedup_radius is not None
            else self.config.dist_threshold * min(tw, th)
        )
        kept = merge_tiled_objects(kept_objects, radius)
        path = getattr(image, "filename", "") or "tiled"
        return ImageAnnotation(path, objects=kept, img_size=image.size)


def _rescale(annotations, sources, config) -> List[ImageAnnotation]:
    """Annotations in network-input pixels -> each source's own pixels."""
    for ann, im in zip(annotations, sources):
        ann.resize((config.width, config.height), im.size)
        ann.img_size = im.size
        if getattr(im, "filename", None):
            ann.image_path = Path(im.filename)
    return annotations


class ExportPredictor:
    """`Predictor`'s surface over a `.sdz` artifact (`export.load_exported`,
    JAX `predictor.py:341-455`): no model code or checkpoint, the decode
    parameters from the artifact's metadata. It gives `serve` what it
    reads of a predictor (`config`, `device`, `feed_uint8`, `to_device`,
    `forward`, `decode`, the submit/collect split).

    A static-batch artifact runs in chunks of its batch, the last padded
    with copies of its last image; a dynamic-batch one takes any batch.
    The program holds sigmoid + NMS, so `ExportDecoder` decodes its
    output with the plain top-k (no kernel)."""

    def __init__(self, artifact, device="cuda", **config_overrides):
        """`config_overrides` sets decode parameters the metadata does not
        carry (max_objects, conf_threshold, ...). The artifact must have
        been traced for `device`."""
        from .data.augment import Normalize
        from .data.decoders import ExportDecoder
        from .export import config_from_metadata, load_exported

        self.device = resolve_device(device)
        self._call, meta = load_exported(Path(artifact).expanduser().resolve(), self.device)
        self.config = config = config_from_metadata(meta, **config_overrides)
        self.meta = meta
        self.decoder = ExportDecoder(config)
        self.batch_size = None if meta.get("dynamic_batch") else int(meta.get("batch_size", 1))
        self._uint8 = meta.get("input_dtype") == "uint8"
        self._normalized = bool(meta.get("normalized"))
        self._host_normalize = Normalize()

    @property
    def feed_uint8(self) -> bool:
        """True when the artifact's input is raw uint8 RGB."""
        return self._uint8

    @property
    def feed_normalize(self) -> bool:
        """True when the host must ImageNet-normalize the feed: the
        artifact was exported without --norm / --uint8_input."""
        return not self._uint8 and not self._normalized

    def _transform(self, image) -> np.ndarray:
        from PIL import Image

        resized = image.resize((self.config.width, self.config.height), Image.BILINEAR)
        if self._uint8:
            return np.asarray(resized, np.uint8)
        if self._normalized:  # the program owns /255 + mean/std: raw [0, 255] floats
            return np.asarray(resized, np.float32)
        return self._host_normalize(resized)

    def to_device(self, arrays) -> torch.Tensor:
        """Stack (H, W, 3) host feeds into one batch on the device."""
        return _stack_to_device(arrays, self.device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) feed on the device -> the program's (B, M+N+4,
        H/4, W/4) output: suppressed heatmaps, raw regression maps."""
        return self._call(batch)

    @torch.inference_mode()
    def decode(self, head: torch.Tensor):
        cfg = self.config
        outputs = split_head_output(head, cfg.n_labels, cfg.n_parts)
        return self.decoder.decode_arrays(outputs, cfg.conf_threshold,
                                          cfg.decoder_dist_thresh)

    def predict_image(self, image) -> ImageAnnotation:
        return self.predict_batch([image])[0]

    def predict_batch(self, images: Sequence) -> List[ImageAnnotation]:
        return self.predict_batch_collect(self.predict_batch_submit(images))

    def predict_batch_submit(self, images: Sequence) -> Optional[tuple]:
        """Device half: every chunk queued on the device, nothing fetched."""
        if not images:
            return None
        with span("sd.predict.submit"):
            sources, arrays = _prepare(images, self._transform)
            step = self.batch_size or len(arrays)
            chunks = []
            for start in range(0, len(arrays), step):
                chunk = arrays[start : start + step]
                n = len(chunk)
                chunk = chunk + [chunk[-1]] * (step - n)  # pad a static batch
                batch = self.to_device(chunk)
                with span("sd.predict.forward"):
                    head = self.forward(batch)
                with span("sd.predict.decode"):
                    chunks.append((self.decode(head), tuple(head.shape[2:]), n))
        return chunks, sources

    def predict_batch_collect(self, handle) -> List[ImageAnnotation]:
        """Host half: fetch each chunk's decode tensors and build the
        annotations."""
        if handle is None:
            return []
        chunks, sources = handle
        annotations: List[ImageAnnotation] = []
        with span("sd.predict.collect"):
            for dec, out_hw, n in chunks:
                anns, _, _ = self.decoder.fetch_and_materialize(dec, out_hw,
                                                                self.config.conf_threshold)
                annotations.extend(anns[:n])
            return _rescale(annotations, sources, self.config)
