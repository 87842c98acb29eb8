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

Under a process group of more than one rank (`parallel.mesh`, torchrun)
the step has the JAX mesh step's global-batch semantics: each rank
brings its slice of the global batch, the augmentation is drawn for the
global batch, BatchNorm takes global statistics, each loss normalizer
is global, and `DistributedDataParallel` averages the gradients of the
ranks' shares of the global loss, scaled by the world size so that the
average is the global loss's gradient. Every rank then takes the same
Adam step; the stats are the global values. `make_sharded_forward` is
the data-parallel inference forward (JAX `steps.py:222-245`); row
(spatial) partitioning is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.network import no_tf32
from ..ops.decode import split_head_output
from ..ops.device_augment import device_augment, step_generator
from ..ops.encode import EncodedTargets, encode_targets
from ..ops.losses import sdnet_loss
from ..parallel.mesh import SPATIAL_NOT_PORTED, all_reduce_sum, rank, world_size
from .state import TrainState


def encode_batch(kp: Dict[str, torch.Tensor], config, out_h: int, out_w: int) -> EncodedTargets:
    return encode_targets(
        kp["anchors_xy"], kp["anchor_cls"], kp["anchor_mask"],
        kp["parts_xy"], kp["part_kind"], kp["part_owner_xy"], kp["part_mask"],
        out_h=out_h, out_w=out_w, n_labels=config.n_labels, n_parts=config.n_parts,
        sigma_gauss=config.sigma_gauss,
    )


def _loss(outputs, targets, config, global_sum=None):
    return sdnet_loss(outputs, targets, hm_loss_fn=config.hm_loss_fn,
                      hm_weight=config.hm_weight, offset_weight=config.offset_weight,
                      embedding_weight=config.embedding_weight, global_sum=global_sum)


def _grid(images: torch.Tensor, config):
    h, w = images.shape[1:3]
    return int(h / config.down_ratio), int(w / config.down_ratio)


def train_step(state: TrainState, images: torch.Tensor, kp: Dict[str, torch.Tensor],
               config, *, augment: bool = False) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch (a rank's slice of the global batch
    under a process group); `state` advances in place. Returns the loss
    stats of the (global) batch (0-d float32 tensors)."""
    dtype = config.compute_dtype
    world = world_size()
    out_h, out_w = _grid(images, config)
    if augment:
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0).to(dtype)
        else:
            images = images.to(dtype)
        images, kp = device_augment(images, kp, step_generator(config.seed, state.step),
                                    out_w=out_w, out_h=out_h, flip_prob=config.flip_prob,
                                    rank=rank(), world=world)
    targets = encode_batch(kp, config, out_h, out_w)
    state.model.train()
    net = state.step_module()
    x = images.permute(0, 3, 1, 2).contiguous()
    with no_tf32(dtype, images.device):
        head = net(x, raw_output=True)
        loss, stats = _loss(split_head_output(head, config.n_labels, config.n_parts),
                            targets, config, global_sum=all_reduce_sum if world > 1 else None)
        state.optimizer.zero_grad(set_to_none=True)
        # DDP averages the ranks' gradients: world * the rank's share
        # makes the average the gradient of the global loss
        (loss * world if world > 1 else loss).backward()
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


def make_sharded_forward(model: torch.nn.Module, mesh=None, spatial: bool = False):
    """Data-parallel inference (JAX `make_sharded_forward`): `forward(images)`
    takes the whole (B, H, W, 3) normalized batch on every rank, runs the
    eval-mode model on this rank's contiguous slice, and all-gathers the
    head outputs, so every rank returns what one forward of the batch
    gives ('anchor_hm', 'part_hm', 'offsets', 'embeddings'). Without a
    mesh of more than one rank it is that one forward. B must divide by
    the ranks. `spatial=True` (image rows over a model axis) raises: row
    partitioning is not ported."""
    import torch.distributed as dist

    if spatial:
        raise NotImplementedError(f"make_sharded_forward(spatial=True): {SPATIAL_NOT_PORTED}")
    ranks = 1 if mesh is None else mesh.size

    @torch.no_grad()
    def forward(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        if ranks == 1:
            return model(images.permute(0, 3, 1, 2).contiguous())
        b = images.shape[0]
        if b % ranks:
            raise ValueError(f"batch {b} does not split over {ranks} ranks")
        local = b // ranks
        part = images[mesh.rank * local:(mesh.rank + 1) * local]
        head = model(part.permute(0, 3, 1, 2).contiguous(), raw_output=True)
        heads = [torch.empty_like(head) for _ in range(ranks)]
        dist.all_gather(heads, head)
        return split_head_output(torch.cat(heads), model.n_labels, model.n_parts)

    return forward
