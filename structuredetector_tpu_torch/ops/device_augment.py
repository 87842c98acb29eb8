"""Training augmentation and image normalization on the device.

The port of `structuredetector_tpu/ops/device_augment.py`: the host only
decodes and resizes; the train step jitters colours, flips the images
and their grid-space keypoints, and normalizes, on the card:

- brightness, contrast, saturation with torchvision's blend semantics
  (factors in [max(0, 1 - s), 1 + s]), then a hue rotation through exact
  RGB -> HSV -> RGB maths, in this fixed order (the JAX package's; the
  reference shuffles the order per image on the host);
- horizontal and vertical flips of each image, applied to the image and
  to its keypoints (x' = out_w - sx - x in grid units);
- ImageNet normalization at the end.

The random draw is split from the transform: `draw_augment_params`
draws every factor and flip flag of a batch from a `torch.Generator`,
and `apply_augment` is a pure function of the images, the keypoints and
those draws. The train step seeds its generator from (seed, step)
(`step_generator`), so a resumed run replays the draws of the unbroken
run, as `jax.random.fold_in(PRNGKey(seed), step)` does in the JAX
package. The numbers are torch's, not `jax.random`'s: the two packages
draw different augmentations from the same seed, and the tests feed the
JAX draws into `apply_augment` to compare the transforms.

Images are (B, H, W, 3) in [0, 1], in the JAX package's layout; the
maths runs in the image dtype (bf16 under amp), with the contrast's luma
mean accumulated in float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# reference RandomColorJitter defaults (transforms.py:38)
BRIGHTNESS, CONTRAST, SATURATION, HUE = 0.25, 0.25, 0.15, 0.05

KEYPOINT_XY = ("anchors_xy", "parts_xy", "part_owner_xy")


class AugmentParams(NamedTuple):
    """One batch's draws, each (B,): the jitter factors, the hue shift and
    the flip flags."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    hflip: torch.Tensor  # bool
    vflip: torch.Tensor  # bool


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator that is a pure function of (seed, step)."""
    state = np.random.SeedSequence((int(seed) & 0xFFFFFFFF, int(step))).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def draw_augment_params(b: int, generator: torch.Generator, *, device,
                        brightness: float = BRIGHTNESS, contrast: float = CONTRAST,
                        saturation: float = SATURATION, hue: float = HUE,
                        flip_prob: float = 0.5) -> AugmentParams:
    """Draw one batch's factors and flags on the CPU from `generator` and
    move them to `device`. A jitter of strength 0 draws factor 1 (no
    change); the draws are made in a fixed order either way."""

    def uniform(lo, hi):
        return torch.rand(b, generator=generator) * (hi - lo) + lo

    def factor(s):
        f = uniform(max(0.0, 1.0 - s), 1.0 + s)
        return f if s > 0 else torch.ones(b)

    draws = AugmentParams(
        brightness=factor(brightness),
        contrast=factor(contrast),
        saturation=factor(saturation),
        hue=uniform(-hue, hue) if hue > 0 else torch.zeros(b),
        hflip=torch.rand(b, generator=generator) < flip_prob,
        vflip=torch.rand(b, generator=generator) < flip_prob,
    )
    return AugmentParams(*(t.to(device, non_blocking=True) for t in draws))


def _luma(images: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of torchvision's grayscale, (B, H, W, 1)."""
    return (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])[..., None]


def _blend(a, b, factor):
    return a * factor + b * (1.0 - factor)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    one, zero = torch.ones_like(maxc), torch.zeros_like(maxc)
    safe = torch.where(delta == 0, one, delta)
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, h) / 6.0
    h = torch.remainder(h, 1.0)
    return torch.stack((h, s, v), dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):
        out = choices[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack((select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)), dim=-1)


def color_jitter(images: torch.Tensor, params: AugmentParams) -> torch.Tensor:
    """Brightness -> contrast -> saturation -> hue on [0, 1] RGB
    (B, H, W, 3), each image by its own factors."""

    def per_image(x):
        return x.to(images.dtype).view(-1, 1, 1, 1)

    images = torch.clamp(images * per_image(params.brightness), 0.0, 1.0)
    # the per-image mean accumulates in f32, then drops to the image dtype
    mean = _luma(images).float().mean(dim=(1, 2, 3), keepdim=True).to(images.dtype)
    images = torch.clamp(_blend(images, mean, per_image(params.contrast)), 0.0, 1.0)
    images = torch.clamp(_blend(images, _luma(images), per_image(params.saturation)), 0.0, 1.0)
    hsv = rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] + params.hue.to(images.dtype).view(-1, 1, 1), 1.0)
    return torch.clamp(hsv_to_rgb(torch.stack((h, hsv[..., 1], hsv[..., 2]), -1)), 0.0, 1.0)


def apply_flips(images: torch.Tensor, kp: Dict[str, torch.Tensor], params: AugmentParams,
                *, out_w: int, out_h: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Flip each image flagged in `params` and its grid-space keypoints.
    The reference mirrors x -> W_in - x - 1 in input pixels; in grid
    units that is x' = out_w - sx - x with sx = out_w / W_in."""
    _, h, w, _ = images.shape
    do_h, do_v = params.hflip, params.vflip
    images = torch.where(do_h.view(-1, 1, 1, 1), images.flip(2), images)
    images = torch.where(do_v.view(-1, 1, 1, 1), images.flip(1), images)
    sx, sy = out_w / w, out_h / h
    kp = dict(kp)
    for name in KEYPOINT_XY:
        x, y = kp[name][..., 0], kp[name][..., 1]
        x = torch.where(do_h[:, None], (out_w - sx) - x, x)
        y = torch.where(do_v[:, None], (out_h - sy) - y, y)
        kp[name] = torch.stack((x, y), dim=-1)
    return images, kp


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] RGB -> ImageNet-normalized, same layout."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def apply_augment(images: torch.Tensor, kp: Dict[str, torch.Tensor], params: AugmentParams,
                  *, out_w: int, out_h: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Jitter -> flips -> normalize with the given draws (JAX
    `device_augment` with its random draws taken out)."""
    images = color_jitter(images, params)
    images, kp = apply_flips(images, kp, params, out_w=out_w, out_h=out_h)
    return normalize_images(images), kp


def device_augment(images: torch.Tensor, kp: Dict[str, torch.Tensor],
                   generator: torch.Generator, *, out_w: int, out_h: int,
                   flip_prob: float = 0.5) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Draw a batch's augmentation from `generator` and apply it."""
    params = draw_augment_params(images.shape[0], generator, device=images.device,
                                 flip_prob=flip_prob)
    return apply_augment(images, kp, params, out_w=out_w, out_h=out_h)
