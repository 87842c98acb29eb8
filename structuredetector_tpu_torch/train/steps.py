"""The train and eval steps: encode + forward + loss (+ backward + Adam).

The port of `structuredetector_tpu/train/steps.py` for one device. The
train step takes the host's batch as it arrives on the device, (B, H, W,
3) images in the JAX package's layout, and a dict of keypoint tensors
(`data.pipeline.keypoints_to_device`):

1. with device augmentation: uint8 -> /255 in float32 -> the compute
   dtype (`steps.py:73-80`), then `ops.device_augment` with the
   generator of (config.seed, step);
2. the dense targets (`ops.encode.encode_targets`);
3. a train-mode forward (bf16 autocast unless fp32), the loss, the
   backward pass, and one Adam step at the schedule's rate.

Nothing here waits for the card: the stats come back as 0-d tensors.
The mesh and sharding branch of the JAX step is not ported (one
device).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.network import no_tf32
from ..ops.decode import split_head_output
from ..ops.device_augment import device_augment, step_generator
from ..ops.encode import EncodedTargets, encode_targets
from ..ops.losses import sdnet_loss
from .state import TrainState


def encode_batch(kp: Dict[str, torch.Tensor], config, out_h: int, out_w: int) -> EncodedTargets:
    return encode_targets(
        kp["anchors_xy"], kp["anchor_cls"], kp["anchor_mask"],
        kp["parts_xy"], kp["part_kind"], kp["part_owner_xy"], kp["part_mask"],
        out_h=out_h, out_w=out_w, n_labels=config.n_labels, n_parts=config.n_parts,
        sigma_gauss=config.sigma_gauss,
    )


def _loss(outputs, targets, config):
    return sdnet_loss(outputs, targets, hm_loss_fn=config.hm_loss_fn,
                      hm_weight=config.hm_weight, offset_weight=config.offset_weight,
                      embedding_weight=config.embedding_weight)


def _grid(images: torch.Tensor, config):
    h, w = images.shape[1:3]
    return int(h / config.down_ratio), int(w / config.down_ratio)


def train_step(state: TrainState, images: torch.Tensor, kp: Dict[str, torch.Tensor],
               config, *, augment: bool = False) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch; `state` advances in place. Returns
    the loss stats of the batch (0-d float32 tensors)."""
    model = state.model
    dtype = config.compute_dtype
    out_h, out_w = _grid(images, config)
    if augment:
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0).to(dtype)
        else:
            images = images.to(dtype)
        images, kp = device_augment(images, kp, step_generator(config.seed, state.step),
                                    out_w=out_w, out_h=out_h, flip_prob=config.flip_prob)
    targets = encode_batch(kp, config, out_h, out_w)
    model.train()
    x = images.permute(0, 3, 1, 2).contiguous()
    with no_tf32(dtype, images.device):
        head = model(x, raw_output=True)
        loss, stats = _loss(split_head_output(head, config.n_labels, config.n_parts),
                            targets, config)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in stats.items()}


@torch.no_grad()
def eval_step(model: torch.nn.Module, images: torch.Tensor, kp: Dict[str, torch.Tensor],
              config, params: Optional[Dict[str, torch.Tensor]] = None):
    """Validation step: an eval-mode forward (running BN statistics), the
    loss stats and the ground-truth heatmaps for the debug panels.
    `params` (e.g. the EMA average) stand in for the model's parameters,
    its buffers stay the live ones. Returns (outputs, stats, gt_maps),
    maps NCHW."""
    out_h, out_w = _grid(images, config)
    targets = encode_batch(kp, config, out_h, out_w)
    model.eval()
    x = images.permute(0, 3, 1, 2).contiguous()
    if params is None:
        outputs = model(x)
    else:
        outputs = torch.func.functional_call(model, params, (x,))
    _, stats = _loss(outputs, targets, config)
    return outputs, stats, {"anchor_hm": targets.anchor_hm, "part_hm": targets.part_hm}
