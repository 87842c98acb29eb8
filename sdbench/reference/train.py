"""The plain reference of SDNet's training step, from the files on disk to
the parameters after Adam: laclouis5/StructureDetector's loader, targets,
loss and optimizer (`src/sdnet/data/transforms.py:121-244`,
`src/sdnet/loss.py:17-117`, `trainer.py:53-135`), with the batch order,
the epoch's input size and the on-card augmentation drawn as the trainer
under test defines them:

- batch order: epoch e shuffles the sorted annotation files with
  `numpy.random.default_rng((seed, e))`, batches of B, the last short one
  dropped, so epoch e's first step is global step e * (n // B);
- input size: epoch 0 the configured size, epoch e > 0 the size times a
  ratio of `MULTISCALE_RATIOS` drawn by
  `numpy.random.default_rng((seed, 0x5C41E, e)).integers(9)`, each side
  snapped down to a multiple of 32 (at least 32);
- loading: PIL decode, bilinear resize to the epoch's size, uint8; each
  annotation scaled to that size, clipped to [0, size - 1], then to the
  stride-4 grid; at most `max_objects` objects and `max_parts` parts in
  object order;
- augmentation of step t: a `torch.Generator` seeded from
  `numpy.random.SeedSequence((seed & 0xFFFFFFFF, t))`, drawing per image
  the brightness, contrast and saturation factors, the hue shift and the
  two flip flags in that order; then brightness, contrast (against the
  luma mean), saturation (against the luma), hue (through HSV), clamped
  to [0, 1] after each, the flips of image and keypoints, ImageNet
  normalization;
- targets: unnormalized Gaussians (sigma = sigma_gauss * min(grid) / 3)
  at the floored grid positions, max-merged per class; offsets and
  embeddings at the floored positions;
- loss: MSE of the clamped sigmoid maps (heatmap weight), masked L1 of the
  offsets at anchors and parts and of the embeddings at parts (each over
  the count of valid keypoints, times its weight);
- Adam (0.9, 0.999, eps 1e-8) at a StepLR rate: the rate / 10 at every
  global step k * int(epochs / lr_step) * (n // B) for k * int(epochs /
  lr_step) < epochs (never where lr_step is 0); batch statistics in every
  BatchNorm.

Float32 with TF32 off. Imports nothing of the program.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from .sdnet import IMAGENET_MEAN, IMAGENET_STD, Net, no_tf32

JITTER = (0.25, 0.25, 0.15, 0.05)  # brightness, contrast, saturation, hue
MULTISCALE_RATIOS = (0.75, 0.8125, 0.875, 0.9375, 1, 1.0625, 1.125, 1.1875, 1.25)


def epoch_size(size, seed: int, epoch: int):
    """The (w, h) that epoch `epoch` loads its images at."""
    if epoch == 0:
        return tuple(size)
    rng = np.random.default_rng((seed, 0x5C41E, epoch))
    ratio = MULTISCALE_RATIOS[int(rng.integers(len(MULTISCALE_RATIOS)))]
    return tuple(max(32, int(ratio * s / 32) * 32) for s in size)


def rate(cfg: dict, step: int, steps_per_epoch: int) -> float:
    """The learning rate of global step `step` (StepLR over steps)."""
    every = int(cfg["epochs"] / cfg["lr_step"]) if cfg["lr_step"] else cfg["epochs"]
    lr, e = cfg["learning_rate"], every
    while every > 0 and e < cfg["epochs"]:
        if step >= e * steps_per_epoch:
            lr *= 0.1
        e += every
    return lr


def epoch_batches(n: int, batch: int, seed: int, epoch: int) -> List[List[int]]:
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return [[int(i) for i in order[s:s + batch]] for s in range(0, n - batch + 1, batch)]


def load_item(json_path: Path, size, labels: Dict[str, int], parts: Dict[str, int],
              anchor_name: str, max_objects: int, max_parts: int, down: float):
    """One image at `size` (uint8 HWC) and its grid keypoints."""
    from PIL import Image

    w, h = size
    ann = json.loads(Path(json_path).read_text())
    image = Image.open(Path(json_path).with_suffix(".jpg"))
    image = image.convert("RGB") if image.mode != "RGB" else image
    iw, ih = image.size
    pixels = np.asarray(image.resize((w, h), Image.BILINEAR), np.uint8)
    out_w, out_h = int(w / down), int(h / down)
    sx, sy = out_w / w, out_h / h

    def scaled(loc):
        x = min(max(loc["x"] * w / iw, 0), w - 1)
        y = min(max(loc["y"] * h / ih, 0), h - 1)
        return x * sx, y * sy

    kp = {"anchors_xy": np.zeros((max_objects, 2), np.float32),
          "anchor_cls": np.zeros(max_objects, np.int64),
          "anchor_mask": np.zeros(max_objects, bool),
          "parts_xy": np.zeros((max_parts, 2), np.float32),
          "part_kind": np.zeros(max_parts, np.int64),
          "part_owner_xy": np.zeros((max_parts, 2), np.float32),
          "part_mask": np.zeros(max_parts, bool)}
    n_parts = 0
    for i, obj in enumerate(ann["objects"][:max_objects]):
        anchor = next(p for p in obj["parts"] if p["kind"] == anchor_name)
        gx, gy = scaled(anchor["location"])
        kp["anchors_xy"][i] = (gx, gy)
        kp["anchor_cls"][i] = labels[obj["label"]]
        kp["anchor_mask"][i] = True
        for p in obj["parts"]:
            if p["kind"] == anchor_name:
                continue
            if n_parts == max_parts:
                break
            kp["parts_xy"][n_parts] = scaled(p["location"])
            kp["part_kind"][n_parts] = parts[p["kind"]]
            kp["part_owner_xy"][n_parts] = (gx, gy)
            kp["part_mask"][n_parts] = True
            n_parts += 1
        if n_parts == max_parts:
            break
    return pixels, kp


def draws(b: int, seed: int, step: int, flip_prob: float):
    """Step `step`'s augmentation draws for a batch of `b`."""
    state = np.random.SeedSequence((int(seed) & 0xFFFFFFFF, int(step))).generate_state(2)
    g = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))

    def uniform(lo, hi):
        return torch.rand(b, generator=g) * (hi - lo) + lo

    bright, contrast, sat, hue = JITTER
    return {"brightness": uniform(1 - bright, 1 + bright),
            "contrast": uniform(1 - contrast, 1 + contrast),
            "saturation": uniform(1 - sat, 1 + sat),
            "hue": uniform(-hue, hue),
            "hflip": torch.rand(b, generator=g) < flip_prob,
            "vflip": torch.rand(b, generator=g) < flip_prob}


def _luma(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _hue_rotate(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV, hue + shift (mod 1), HSV -> RGB; (B, H, W, 3) in [0, 1]."""
    r, g, b = x.unbind(-1)
    maxc, minc = x.amax(-1), x.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-30), torch.zeros_like(maxc))
    d = delta.clamp(min=1e-30)
    h = torch.where(maxc == r, (g - b) / d,
                    torch.where(maxc == g, 2.0 + (b - r) / d, 4.0 + (r - g) / d))
    h = torch.where(delta > 0, h / 6.0, torch.zeros_like(h)).remainder(1.0)
    h = (h + shift.view(-1, 1, 1)).remainder(1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.long() % 6
    table = torch.stack([torch.stack(c, -1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], 0)
    return torch.gather(table, 0, i[None, ..., None].expand(1, *i.shape, 3))[0]


def augment(images_u8: torch.Tensor, kp: Dict[str, torch.Tensor], d, out_w: int, out_h: int):
    """(B, H, W, 3) uint8 -> (B, 3, H, W) normalized float32, keypoints flipped."""
    x = images_u8.float() / 255.0
    dev = x.device
    per = {k: v.to(dev) for k, v in d.items()}

    def f(k):
        return per[k].view(-1, 1, 1, 1)

    x = (x * f("brightness")).clamp(0, 1)
    mean = _luma(x).mean(dim=(1, 2, 3), keepdim=True)
    x = (x * f("contrast") + mean * (1 - f("contrast"))).clamp(0, 1)
    x = (x * f("saturation") + _luma(x) * (1 - f("saturation"))).clamp(0, 1)
    x = _hue_rotate(x, per["hue"]).clamp(0, 1)
    hf, vf = per["hflip"], per["vflip"]
    x = torch.where(hf.view(-1, 1, 1, 1), x.flip(2), x)
    x = torch.where(vf.view(-1, 1, 1, 1), x.flip(1), x)
    w, h = x.shape[2], x.shape[1]
    sx, sy = out_w / w, out_h / h
    kp = dict(kp)
    for name in ("anchors_xy", "parts_xy", "part_owner_xy"):
        xs, ys = kp[name][..., 0], kp[name][..., 1]
        xs = torch.where(hf[:, None], out_w - sx - xs, xs)
        ys = torch.where(vf[:, None], out_h - sy - ys, ys)
        kp[name] = torch.stack((xs, ys), -1)
    mean_c = torch.tensor(IMAGENET_MEAN, device=dev)
    std_c = torch.tensor(IMAGENET_STD, device=dev)
    return ((x - mean_c) / std_c).permute(0, 3, 1, 2).contiguous(), kp


def _splat(xy, cls, mask, n_ch, out_h, out_w, sigma):
    b = xy.shape[0]
    fx, fy = torch.floor(xy[..., 0]), torch.floor(xy[..., 1])
    gy = torch.arange(out_h, device=xy.device, dtype=torch.float32).view(1, 1, out_h, 1)
    gx = torch.arange(out_w, device=xy.device, dtype=torch.float32).view(1, 1, 1, out_w)
    g = torch.exp(-((gx - fx[..., None, None]) ** 2 + (gy - fy[..., None, None]) ** 2)
                  / (2 * sigma ** 2)) * mask[..., None, None]
    hm = torch.zeros((b, n_ch, out_h, out_w), device=xy.device)
    for c in range(n_ch):
        hm[:, c] = (g * (cls == c)[..., None, None]).amax(dim=1) if xy.shape[1] else 0.0
    inds = (fy * out_w + fx).long() * mask
    offsets = (xy - torch.stack((fx, fy), -1)) * mask[..., None]
    return hm, inds, offsets


def _gather(feat, inds):
    b, c = feat.shape[:2]
    return feat.reshape(b, c, -1).gather(2, inds[:, None, :].expand(b, c, inds.shape[1])).transpose(1, 2)


def _masked_l1(feat, target, inds, mask):
    m = mask.float()
    total = ((_gather(feat, inds) - target).abs() * m[..., None]).sum()
    return total / m.sum().clamp(min=1.0)


def loss(head: torch.Tensor, kp, n_labels: int, n_parts: int, sigma_gauss: float,
         weights=(1.0, 1e-3, 1e-3)) -> dict:
    """The three weighted terms of the loss; their sum is the step's loss."""
    out_h, out_w = head.shape[2:]
    sigma = sigma_gauss * min(out_w, out_h) / 3.0
    a_hm, a_inds, a_off = _splat(kp["anchors_xy"], kp["anchor_cls"], kp["anchor_mask"],
                                 n_labels, out_h, out_w, sigma)
    p_hm, p_inds, p_off = _splat(kp["parts_xy"], kp["part_kind"], kp["part_mask"],
                                 n_parts, out_h, out_w, sigma)
    emb = (kp["part_owner_xy"] - kp["parts_xy"]) * kp["part_mask"][..., None]
    nb = n_labels + n_parts
    sig = torch.sigmoid(head[:, :nb]).clamp(1e-6, 1 - 1e-6)
    hm_w, off_w, emb_w = weights
    hm_loss = hm_w * (((sig[:, :n_labels] - a_hm) ** 2).mean()
                      + ((sig[:, n_labels:] - p_hm) ** 2).mean())
    offsets = head[:, nb:nb + 2]
    off_loss = off_w * (_masked_l1(offsets, a_off, a_inds, kp["anchor_mask"])
                        + _masked_l1(offsets, p_off, p_inds, kp["part_mask"]))
    emb_loss = emb_w * _masked_l1(head[:, nb + 2:nb + 4], emb, p_inds, kp["part_mask"])
    return {"hm_loss": hm_loss, "offset_loss": off_loss, "embedding_loss": emb_loss}


def adam_step(params, grads, state, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's t-th step; `state` {leaf: (m, v)} is updated in place."""
    for k, g in grads.items():
        m, v = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        params[k].data.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(sd: Dict[str, torch.Tensor], backbone: str, files: Sequence[Path], cfg: dict,
                steps: int = 3, quant=None, epoch: int = 0, adam=None) -> dict:
    """The first `steps` steps of epoch `epoch` from the parameters and
    buffers `sd`, over the annotation files `files` (sorted, each beside
    its .jpg). `adam`: Adam's state at the epoch's start, {"t": steps
    done, "m": {leaf: tensor}, "v": {leaf: tensor}}; None: a fresh one.
    `cfg` holds seed, batch_size, width, height, max_objects, max_parts,
    down_ratio, sigma_gauss, learning_rate, epochs, lr_step, flip_prob,
    labels, parts, anchor_name and the loss weights. Returns {"losses" (a
    step's loss terms), "head" (the first step's network output), "grad"
    (the first step's gradient), "delta" (the parameters' change after
    `steps`)}."""
    dev = next(iter(sd.values())).device
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in sd.items() if _is_param(k)}
    start = {k: v.detach().clone() for k, v in params.items()}
    buffers = {k: v for k, v in sd.items() if not _is_param(k)}
    size = epoch_size((cfg["width"], cfg["height"]), cfg["seed"], epoch)
    out_w, out_h = int(size[0] / cfg["down_ratio"]), int(size[1] / cfg["down_ratio"])
    n_l, n_p = len(cfg["labels"]), len(cfg["parts"])
    per_epoch = len(files) // cfg["batch_size"]
    batches = epoch_batches(len(files), cfg["batch_size"], cfg["seed"], epoch)[:steps]
    t_done = adam["t"] if adam is not None else 0
    state = ({k: (adam["m"][k].clone().float(), adam["v"][k].clone().float()) for k in params}
             if adam is not None else {})
    losses, first_grad, first_head = [], None, None
    with no_tf32():
        for i, idxs in enumerate(batches):
            t = epoch * per_epoch + i  # the global step: the draws' key and the rate's
            items = [load_item(files[j], size, cfg["labels"], cfg["parts"], cfg["anchor_name"],
                               cfg["max_objects"], cfg["max_parts"], cfg["down_ratio"])
                     for j in idxs]
            images = torch.from_numpy(np.stack([p for p, _ in items])).to(dev)
            kp = {k: torch.from_numpy(np.stack([k_[k] for _, k_ in items])).to(dev)
                  for k in items[0][1]}
            d = draws(len(idxs), cfg["seed"], t, cfg["flip_prob"])
            x, kp = augment(images, kp, d, out_w, out_h)
            if quant is not None:  # the network's input in the control's precision too
                x = quant(x)
            head = Net({**params, **buffers}, backbone, train=True, quant=quant)(x)
            terms = loss(head, kp, n_l, n_p, cfg["sigma_gauss"], tuple(cfg["loss_weights"]))
            total = sum(terms.values())
            grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in grads.items()}
                first_head = head.detach().clone()
            with torch.no_grad():
                adam_step(params, grads, state, t_done + i + 1, rate(cfg, t, per_epoch))
            del head, total, grads, terms
    delta = {k: (params[k].detach() - start[k]) for k in params}
    return {"losses": losses, "head": first_head, "grad": first_grad, "delta": delta}


def _is_param(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var", "num_batches_tracked"))
