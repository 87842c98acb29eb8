"""Host-side image transforms of the prediction and evaluation paths.

The part of `structuredetector_tpu/data/augment.py` that serving,
`detect` and `evaluate` need: `Compose`, `Resize`, `Normalize`,
`ValidationAugmentation` (reference `transforms.py:253-267`) and
`PredictionTransformation` (`transforms.py:270-286`). The training
transforms wait for the training slice of the port. PIL is imported
inside the functions that use it, so a caller that feeds decoded arrays
needs no Pillow.
"""

from __future__ import annotations

import numpy as np

from ..annotations import ImageAnnotation, clip_annotation
from ..ops.device_augment import IMAGENET_MEAN, IMAGENET_STD


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


class Normalize:
    """PIL -> float32 HWC in [0, 1], ImageNet mean/std normalized
    (transforms.py:109-118)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target=None):
        arr = np.asarray(image, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        arr = (arr - self.mean) / self.std
        if target is None:
            return arr
        return arr, target


class ToSample:
    """Terminal transform of the evaluation path: the annotation, already
    in input-image space, is clipped in place to the image bounds, as the
    JAX package's `Flatten` clips it before it is compared with
    predictions; returns the sample dict the `Loader` collates."""

    def __call__(self, image: np.ndarray, target: ImageAnnotation) -> dict:
        in_h, in_w = image.shape[:2]
        clip_annotation(target, (in_w, in_h))
        return {"image": image, "annotation": target}


class ValidationAugmentation:
    """Resize -> Normalize -> clip (reference `transforms.py:253-267`):
    a PIL image and its annotation -> {"image": (H, W, 3) float32,
    "annotation": annotation in input pixels}."""

    def __init__(self, config):
        self.transform = Compose(
            [Resize((config.width, config.height)), Normalize(), ToSample()]
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
            arr = np.asarray(resized, np.uint8)
            if arr.ndim == 2:
                arr = arr[..., None]
            return arr
        return self.normalize(resized)
