"""Host-side image and annotation transforms.

The port of `structuredetector_tpu/data/augment.py` (reference
`transforms.py`):

- `TrainAugmentation`: Resize -> Flatten without augmentation; Resize ->
  raw uint8 (or float [0, 1]) -> Flatten when the card augments
  (`ops.device_augment`, the default); Resize -> ColorJitter -> HFlip ->
  VFlip -> Normalize -> Flatten when the host augments with PIL
  (`transforms.py:216-235`). `trigger_random_resize` re-rolls the input
  size each epoch over ratios 0.75 ... 1.25 snapped to multiples of 32
  (`transforms.py:212`, `:237-244`);
- `ValidationAugmentation` = Resize -> Normalize -> Flatten
  (`transforms.py:253-267`);
- `PredictionTransformation` = Resize -> Normalize only
  (`transforms.py:270-286`).

Where the host does no per-pixel augmentation (validation,
`--no_augmentation`, the device-augment feed), `native_batch_apply`
decodes a whole batch through the native library instead of PIL
(`data/native.py`; byte-equal in exact mode), and `TrainAugmentation.
native_apply` one item of the device-augment feed; each flattens the
annotation as the PIL path does.

Documented divergence, as in the JAX package: the reference draws its
flip trigger from a normal distribution (`torch.randn(1) < prob`), so
prob 0.5 flips ~69 % of the time; here the draw is uniform, and
`legacy_flip=True` reproduces the reference. PIL is imported inside the
functions that use it, so a caller that feeds decoded arrays needs no
Pillow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..annotations import ImageAnnotation, hflip_annotation, vflip_annotation
from ..ops.device_augment import IMAGENET_MEAN, IMAGENET_STD
from . import native
from .pipeline import FlatKeypoints, flatten_annotation

MULTISCALE_RATIOS = (0.75, 0.8125, 0.875, 0.9375, 1, 1.0625, 1.125, 1.1875, 1.25)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, *inputs):
        for t in self.transforms:
            inputs = t(*inputs)
        return inputs

    def __repr__(self):
        return f"Compose(transforms: {self.transforms})"


class Resize:
    """Resize an image and its annotation to (width, height)."""

    def __init__(self, size):
        if isinstance(size, int):
            self.width, self.height = size, size
        else:
            self.width, self.height = size

    def __call__(self, image, target):
        from PIL import Image

        resized = image.resize((self.width, self.height), Image.BILINEAR)
        annotation = target.resized(image.size, (self.width, self.height))
        return resized, annotation

    def __repr__(self):
        return f"Resize(width: {self.width}, height: {self.height})"


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, rng: Optional[np.random.Generator] = None,
                 legacy_flip: bool = False):
        self.prob = prob
        self.rng = rng or np.random.default_rng()
        self.legacy_flip = legacy_flip

    def _trigger(self) -> bool:
        if self.legacy_flip:  # reference transforms.py:14
            # the reference compares a normal draw with prob (~69 % at
            # 0.5); prob 0 still never flips and prob 1 always does
            if self.prob <= 0.0:
                return False
            if self.prob >= 1.0:
                return True
            return self.rng.standard_normal() < self.prob
        return self.rng.random() < self.prob

    def __call__(self, image, target: ImageAnnotation):
        from PIL import Image

        if self._trigger():
            return image.transpose(Image.FLIP_LEFT_RIGHT), hflip_annotation(target, image.size)
        return image, target


class RandomVerticalFlip(RandomHorizontalFlip):
    def __call__(self, image, target: ImageAnnotation):
        from PIL import Image

        if self._trigger():
            return image.transpose(Image.FLIP_TOP_BOTTOM), vflip_annotation(target, image.size)
        return image, target


class RandomColorJitter:
    """Brightness/contrast/saturation/hue jitter with torchvision-style
    factor ranges, applied in a random order (transforms.py:37-47)."""

    def __init__(self, brightness=0.25, contrast=0.25, saturation=0.15, hue=0.05,
                 rng: Optional[np.random.Generator] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target: ImageAnnotation):
        from PIL import ImageEnhance

        rng = self.rng
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = rng.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            shift = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, s=shift: _hue_shift(im, s))
        rng.shuffle(ops)
        for op in ops:
            image = op(image)
        return image, target


def _hue_shift(image, shift: float):
    """Rotate hue by `shift` (a fraction of the hue circle)."""
    from PIL import Image

    hsv = np.array(image.convert("HSV"), np.uint8)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(shift * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


def _hwc(image, dtype) -> np.ndarray:
    arr = np.asarray(image, dtype)
    return arr[..., None] if arr.ndim == 2 else arr


class Normalize:
    """PIL -> float32 HWC in [0, 1], ImageNet mean/std normalized
    (transforms.py:109-118)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target=None):
        arr = (_hwc(image, np.float32) / 255.0 - self.mean) / self.std
        return arr if target is None else (arr, target)


class Raw01:
    """PIL -> float32 HWC in [0, 1], not normalized: the float feed of
    the device augmentation."""

    def __call__(self, image, target=None):
        arr = _hwc(image, np.float32) / 255.0
        return arr if target is None else (arr, target)


class RawU8:
    """PIL -> uint8 HWC, the pixels as they are: the default feed of the
    device augmentation (/255 runs on the card, a quarter of float32's
    host-to-device bytes)."""

    def __call__(self, image, target=None):
        arr = _hwc(image, np.uint8)
        return arr if target is None else (arr, target)


class Flatten:
    """Terminal transform: the annotation, clipped in place to the image,
    and its padded keypoint arrays -> the sample dict the `Loader`
    collates."""

    def __init__(self, config):
        self.config = config

    def __call__(self, image: np.ndarray, target: ImageAnnotation) -> dict:
        in_h, in_w = image.shape[:2]
        out_w = int(in_w / self.config.down_ratio)
        out_h = int(in_h / self.config.down_ratio)
        kp = flatten_annotation(
            target,
            labels=self.config.labels,
            parts=self.config.parts,
            max_objects=self.config.max_objects,
            max_parts=self.config.max_parts,
            in_size=(in_w, in_h),
            out_size=(out_w, out_h),
        )
        return {"image": image, "keypoints": kp, "annotation": target}


def _native_load_and_flatten(config, paths, targets, size, *, normalize: bool,
                             exact: bool, uint8: bool, n_threads: int) -> dict:
    """The whole-batch native path (JAX `augment.py:248-295`): one C++
    call decodes and resizes every image of the batch into one NHWC
    buffer on its own threads, then each annotation is stamped with its
    file's size, resized and flattened as the PIL path does. Returns the
    collated batch dict."""
    w, h = size
    images, orig, ok = native.load_batch(
        paths, w, h, n_threads=n_threads, normalize=normalize, exact=exact,
        dtype=np.uint8 if uint8 else np.float32)
    if not ok.all():
        bad = [str(p) for p, good in zip(paths, ok) if not good]
        raise IOError(f"native decode failed for: {bad}")
    flatten = Flatten(config)
    kps, annotations = [], []
    for image, target, (ow, oh) in zip(images, targets, orig):
        target.img_size = (int(ow), int(oh))
        sample = flatten(image, target.resized(target.img_size, (w, h)))
        kps.append(sample["keypoints"])
        annotations.append(sample["annotation"])
    keypoints = FlatKeypoints(*(np.stack(field) for field in zip(*kps)))
    return {"image": images, "keypoints": keypoints, "annotation": annotations}


class TrainAugmentation:
    ratios = MULTISCALE_RATIOS  # transforms.py:212

    def __init__(self, config, rng: Optional[np.random.Generator] = None,
                 legacy_flip: bool = False):
        self.config = config
        self.rng = rng or np.random.default_rng(config.seed)
        self.device_augment = config.device_augment and not config.no_augmentation
        self.uint8_feed = False  # True only when the card augments
        if config.no_augmentation:
            transforms = [Resize((config.width, config.height)), Normalize(), Flatten(config)]
        elif self.device_augment:
            # the host only resizes; jitter, flips and normalization run on
            # the card inside the train step
            self.uint8_feed = config.uint8_feed
            transforms = [Resize((config.width, config.height)),
                          RawU8() if self.uint8_feed else Raw01(), Flatten(config)]
        else:
            fp = config.flip_prob
            transforms = [
                Resize((config.width, config.height)),
                RandomColorJitter(rng=self.rng),
                RandomHorizontalFlip(prob=fp, rng=self.rng, legacy_flip=legacy_flip),
                RandomVerticalFlip(prob=fp, rng=self.rng, legacy_flip=legacy_flip),
                Normalize(),
                Flatten(config),
            ]
        self.transform = Compose(transforms)

    @property
    def current_size(self) -> Tuple[int, int]:
        r = self.transform.transforms[0]
        return (r.width, r.height)

    def bucket_sizes(self):
        """Every (width, height) `trigger_random_resize` can pick, the
        configured size first."""
        sizes = [(self.config.width, self.config.height)]
        if not self.config.no_augmentation:
            for ratio in self.ratios:
                size = self._size(ratio)
                if size not in sizes:
                    sizes.append(size)
        return sizes

    def _size(self, ratio):
        return (max(32, int(ratio * self.config.width / 32) * 32),
                max(32, int(ratio * self.config.height / 32) * 32))

    def native_apply(self, image_path, target: ImageAnnotation) -> dict:
        """The per-item native route of the device-augment feed: decode and
        resize in C++ to raw uint8 (or [0, 1] float); jitter, flips and
        normalization run on the card."""
        if not self.device_augment:
            raise ValueError("the per-item native route is the device-augment feed only")
        size = self.current_size
        arr, orig_size = native.load_image(
            image_path, *size, normalize=False, exact=not self.config.native_io_fast,
            dtype=np.uint8 if self.uint8_feed else np.float32)
        target.img_size = orig_size
        return Flatten(self.config)(arr, target.resized(orig_size, size))

    def supports_native_batch(self) -> bool:
        """The whole-batch native loader covers the modes where the host
        does no per-pixel augmentation: `--no_augmentation` (resize and
        normalize) and the device-augment feed. PIL's host augmentation
        keeps the per-sample path."""
        return self.config.no_augmentation or self.device_augment

    def native_batch_apply(self, paths, targets, n_threads: int = 4) -> dict:
        if not self.supports_native_batch():
            raise ValueError("whole-batch native loading needs --no_augmentation or the "
                             "device-augment feed")
        return _native_load_and_flatten(
            self.config, paths, targets, self.current_size,
            normalize=not self.device_augment, exact=not self.config.native_io_fast,
            uint8=self.uint8_feed, n_threads=n_threads)

    def trigger_random_resize(self, next_epoch: Optional[int] = None):
        """Re-roll the input size for the next epoch (transforms.py:237-
        244), snapped to multiples of 32. With `next_epoch` the roll is a
        pure function of (seed, next_epoch), so a resumed run follows the
        unbroken run's sizes; without it, the stateful draw is used."""
        if self.config.no_augmentation:
            return
        rng = (np.random.default_rng((self.config.seed, 0x5C41E, next_epoch))
               if next_epoch is not None else self.rng)
        ratio = self.ratios[int(rng.integers(len(self.ratios)))]
        self.transform.transforms[0] = Resize(self._size(ratio))

    def __call__(self, image, target):
        return self.transform(image, target)


class ValidationAugmentation:
    """Resize -> Normalize -> Flatten (reference `transforms.py:253-267`):
    a PIL image and its annotation -> {"image": (H, W, 3) float32,
    "keypoints": FlatKeypoints, "annotation": the annotation in input
    pixels, clipped to the image}."""

    def __init__(self, config):
        self.config = config
        self.transform = Compose(
            [Resize((config.width, config.height)), Normalize(), Flatten(config)]
        )

    def __call__(self, image, target):
        return self.transform(image, target)

    def supports_native_batch(self) -> bool:
        return True

    def native_batch_apply(self, paths, targets, n_threads: int = 4) -> dict:
        """Decode, resize and normalize the batch in C++ (exact mode, always)."""
        cfg = self.config
        return _native_load_and_flatten(cfg, paths, targets, (cfg.width, cfg.height),
                                        normalize=True, exact=True, uint8=False,
                                        n_threads=n_threads)


class RawImage:
    """PIL -> float32 HWC in [0, 255], not normalized: the feed of an
    exported graph that normalizes itself (reference CoreMLTransforms,
    transforms.py:289-304)."""

    def __call__(self, image, target=None):
        arr = _hwc(image, np.float32)
        return arr if target is None else (arr, target)


class ExportTransforms:
    """Resize -> RawImage -> Flatten: evaluation samples for an artifact
    exported with `--norm` (JAX `augment.py:448-459`)."""

    def __init__(self, config):
        self.transform = Compose(
            [Resize((config.width, config.height)), RawImage(), Flatten(config)]
        )

    def __call__(self, image, target):
        return self.transform(image, target)


class PredictionTransformation:
    """Image-only path for prediction (transforms.py:270-286).

    With `device_normalize`, the host only resizes and emits uint8 HWC;
    the /255 + ImageNet normalization then runs on the device
    (`Predictor`), a quarter of the host->device bytes of float32.
    """

    def __init__(self, config, device_normalize: bool = False):
        self.resize = Resize((config.width, config.height))
        self.device_normalize = device_normalize
        self.normalize = Normalize()

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        resized = image.resize((self.resize.width, self.resize.height), Image.BILINEAR)
        if self.device_normalize:
            return _hwc(resized, np.uint8)
        return self.normalize(resized)
