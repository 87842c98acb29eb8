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
the step has the JAX mesh step's global-batch semantics: each rank of
the data axis brings its slice of the global batch, the augmentation is
drawn for the global batch, BatchNorm takes global statistics, each loss
normalizer is global, and `DistributedDataParallel` averages the
gradients of the ranks' shares of the global loss, scaled by the ranks'
count so that the average is the global loss's gradient. Every rank
then takes the same Adam step; the stats are the global values.

On the model axis (`parallel.partition`): a model sharded by
`shard_model` (`--model_parallel M`) runs its channel-sharded forward;
the ranks of a model group share their batch, DDP runs over the data
group, and the replicated parameters' gradients are averaged over the
model group. With `spatial=True` (JAX `make_train_step(spatial=True)`)
the rows of a data rank's batch split over the model axis instead
(`RowPlan`): the parameters are replicated (JAX also shards their Cout
under `spatial=True`, placement that leaves the numerics alone), the BN
statistics are the whole mesh's, the augmentation and the targets are
the data rank's whole batch's, the loss reads the gathered head output,
and DDP averages every gradient over the whole mesh.
`make_sharded_forward` is the inference forward over a mesh (JAX
`steps.py:222-245`): the batch over the data axis, a sharded model
through its plan, the rows over the model axis under `spatial=True`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ..models.network import no_tf32
from ..ops.decode import split_head_output
from ..ops.device_augment import device_augment, step_generator
from ..ops.encode import EncodedTargets, encode_targets
from ..ops.losses import sdnet_loss
from ..parallel.mesh import all_reduce_sum, rank, world_size
from ..parallel.partition import RowPlan, all_gather, unshard_model
from ..tracing import span
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
               config, *, augment: bool = False, mesh=None,
               spatial: bool = False) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch (a data rank's slice of the global
    batch under a process group); `state` advances in place. Returns the
    loss stats of the (global) batch (0-d float32 tensors).

    `mesh` (`parallel.mesh.create_mesh`): where the batch splits (None:
    every rank on the data axis). A model sharded over the model axis
    (`state.partition`) steps on the mesh it was sharded over;
    `spatial=True` splits the rows of a replicated model's batch over the
    mesh's model axis."""
    dtype = config.compute_dtype
    if spatial and (mesh is None or state.partition is not None):
        raise ValueError("train_step(spatial=True) takes a mesh and a replicated model")
    plan = RowPlan(mesh) if spatial else state.partition
    if plan is not None and plan.mesh is not mesh:
        raise ValueError("a model sharded over the model axis steps on its mesh (mesh=)")
    if mesh is not None:
        index, ranks, group = mesh.data_index, mesh.data, mesh.data_group
    else:
        index, ranks, group = rank(), world_size(), None
    out_h, out_w = _grid(images, config)
    if augment:
        with span("sd.train.augment"):
            if images.dtype == torch.uint8:
                images = (images.float() / 255.0).to(dtype)
            else:
                images = images.to(dtype)
            images, kp = device_augment(images, kp, step_generator(config.seed, state.step),
                                        out_w=out_w, out_h=out_h, flip_prob=config.flip_prob,
                                        rank=index, world=ranks)
    with span("sd.train.encode"):
        targets = encode_batch(kp, config, out_h, out_w)
    state.model.train()
    # DDP averages over the data group, or under `spatial` over the whole
    # mesh, where each rank's gradient is its rows' part of its data rank's
    net = state.step_module(None if spatial else group)
    scale = mesh.size if spatial else ranks
    x = images.permute(0, 3, 1, 2).contiguous()
    global_sum = functools.partial(all_reduce_sum, group=group) if ranks > 1 else None
    with no_tf32(dtype, images.device):
        with span("sd.train.forward"):
            head = net(x, raw_output=True, partition=plan)
            loss, stats = _loss(split_head_output(head, config.n_labels, config.n_parts),
                                targets, config, global_sum=global_sum)
        with span("sd.train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            # scale * the rank's share makes DDP's average the gradient of
            # the global loss
            (loss * scale if scale > 1 else loss).backward()
    with span("sd.train.optimizer"):
        if state.partition is not None:
            state.partition.average_replicated_grads(state.model)
        state.apply_gradients()
    return {k: v.detach() for k, v in stats.items()}


@torch.no_grad()
def eval_step(model: torch.nn.Module, images: torch.Tensor, kp: Dict[str, torch.Tensor],
              config, params: Optional[Dict[str, torch.Tensor]] = None, partition=None):
    """Validation step: an eval-mode forward (running BN statistics), the
    loss stats and the ground-truth heatmaps for the debug panels.
    `params` (e.g. the EMA average) stand in for the model's parameters,
    its buffers stay the live ones; `partition` is the plan of a model
    sharded over the model axis. Returns (outputs, stats, gt_maps), maps
    NCHW."""
    out_h, out_w = _grid(images, config)
    targets = encode_batch(kp, config, out_h, out_w)
    model.eval()
    x = images.permute(0, 3, 1, 2).contiguous()
    if params is None:
        outputs = model(x, partition=partition)
    else:
        outputs = torch.func.functional_call(model, params, (x,), {"partition": partition})
    _, stats = _loss(outputs, targets, config)
    return outputs, stats, {"anchor_hm": targets.anchor_hm, "part_hm": targets.part_hm}


def make_sharded_forward(model: torch.nn.Module, mesh=None, spatial: bool = False,
                         partition=None):
    """Inference over a mesh (JAX `make_sharded_forward`): `forward(images)`
    takes the whole (B, H, W, 3) normalized batch on every rank and
    returns on every rank what one forward of the batch gives
    ('anchor_hm', 'part_hm', 'offsets', 'embeddings'). The batch splits
    over the mesh's data axis (B must divide by it): each rank runs its
    data index's contiguous slice in eval mode, every rank of a model
    group the same images, and the head outputs are all-gathered over the
    data group. `partition` is the plan of a model sharded over the model
    axis (`parallel.partition.shard_model`), which every forward then
    takes; a sharded model without it raises a ValueError. With
    `spatial=True` the image rows split over the model axis too
    (`parallel.partition.RowPlan`: a giant image rides several devices),
    gathered along the rows before the batch; a sharded model then runs
    as a replica with its whole weights, gathered once here (a collective
    of the model group), as JAX's program runs on `shard_variables`.
    Without a mesh of more than one rank it is one forward."""
    if spatial and partition is not None:
        model, partition = unshard_model(model, partition), None
    ranks, index, group, plan = 1, 0, None, partition
    if mesh is not None and mesh.size > 1:
        ranks, index, group = mesh.data, mesh.data_index, mesh.data_group
        if spatial:
            plan = RowPlan(mesh)

    @torch.no_grad()
    def forward(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        b = images.shape[0]
        if b % ranks:
            raise ValueError(f"batch {b} does not split over the {ranks} ranks of the data axis")
        local = b // ranks
        part = images[index * local:(index + 1) * local].permute(0, 3, 1, 2).contiguous()
        head = model(part, raw_output=True, partition=plan)
        if ranks > 1:
            head = all_gather(head, 0, group, ranks, mesh.backend)
        return split_head_output(head, model.n_labels, model.n_parts)

    return forward
