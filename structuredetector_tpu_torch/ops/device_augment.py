"""On-device image normalization.

The part of `structuredetector_tpu/ops/device_augment.py` the serving
path runs: ImageNet normalization of [0, 1] RGB on the device. The
training augmentations wait for the training slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] RGB -> ImageNet-normalized, same layout."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
