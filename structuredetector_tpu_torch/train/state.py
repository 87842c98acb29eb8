"""Train state: the model (parameters and BN buffers), Adam, and the step.

The port of `structuredetector_tpu/train/state.py`. The reference owns a
torch module, Adam and StepLR (`trainer.py:53-56`; step size epochs //
lr_step, `args.py:213-215`); the JAX package turns StepLR into an optax
piecewise-constant schedule over optimizer steps, and the port keeps
that schedule: `torch.optim.Adam` (betas 0.9/0.999, eps 1e-8, no weight
decay) with its learning rate set before every step from
`make_lr_schedule` at the state's step count. The rate decays /10 at
each boundary, from the step equal to it on (optax's
`piecewise_constant_schedule`).

Under data parallelism the state keeps the module itself: the optimizer
is built over its parameters, and `state_dict` (the checkpoints, the
`.msgpack` snapshots) has its keys, with no `module.` prefix. The
`DistributedDataParallel` wrapper that the train step calls lives beside
it (`TrainState.step_module`). Under the model axis
(`parallel.partition.shard_model`, whose `ChannelPlan` the state keeps
as `partition`) the parameters and Adam's moments are the rank's Cout
slices; `state_dict` gathers them whole and
`load_state_dict` takes whole tensors and keeps the rank's slices, so a
checkpoint is the same file whatever the mesh that wrote or reads it.

On one card the state also holds the train step's CUDA graphs
(`train.graphs.StepGraphs`, `graphs`). They read the parameters, their
gradients and Adam's state in place; a loaded state is copied into the
tensors they read, and the checkpoint's layout is the eager step's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..parallel.mesh import world_size
from .graphs import StepGraphs


def make_lr_schedule(config, steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR(gamma=0.1, step_size=epochs // lr_step) over optimizer
    steps: step -> learning rate."""
    lr = config.learning_rate
    step_epochs = config.lr_step_epochs()
    if step_epochs <= 0:
        # epochs < lr_step: no decay ever fires (the reference's StepLR
        # would fail on step_size 0)
        return lambda step: lr
    boundaries = []
    e = step_epochs
    while e < config.epochs:
        boundaries.append(e * steps_per_epoch)
        e += step_epochs

    def schedule(step: int) -> float:
        value = lr
        for b in boundaries:
            if step >= b:
                value *= 0.1
        return value

    return schedule


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's update (b1 0.9, b2 0.999, eps 1e-8, no weight decay);
    the fused kernel on the card."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, fused=on_card or None)


class TrainState:
    """The model, its optimizer, the learning-rate schedule and the count
    of optimizer steps taken. `state_dict` holds all that a resumed run
    needs. `partition`: None, or the `parallel.partition.ChannelPlan` of
    a model sharded over the mesh's model axis, which the train step's
    forward takes."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], step: int = 0, partition=None):
        self.model = model
        self.partition = partition
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.step = step
        self._ddp: Optional[DistributedDataParallel] = None
        self.graphs = StepGraphs()

    def step_module(self, group=None) -> torch.nn.Module:
        """The module the train step calls: the model, or where `group` (None:
        the default process group) holds more than one rank a
        `DistributedDataParallel` around it over that group, made at the
        first call (every rank takes its first step together; DDP's
        construction broadcasts the group's first rank's parameters). The
        BN buffers are not broadcast: the global-batch BatchNorm keeps them
        equal."""
        if world_size() == 1 or dist.get_world_size(group) == 1:
            return self.model
        if self._ddp is None:
            device = next(self.model.parameters()).device
            self._ddp = DistributedDataParallel(
                self.model, device_ids=[device] if device.type == "cuda" else None,
                broadcast_buffers=False, process_group=group)
        return self._ddp

    def apply_gradients(self) -> None:
        """One Adam step at the schedule's rate for the current step."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> dict:
        """The whole state; under the model axis a collective of every rank."""
        model, optimizer = self.model.state_dict(), self.optimizer.state_dict()
        if self.partition is not None:
            model = self.partition.full_state_dict(model)
            optimizer = self.partition.full_optimizer_state(optimizer, self._param_names())
        return {"step": self.step, "model": model, "optimizer": optimizer}

    def load_state_dict(self, sd: dict) -> None:
        model, optimizer = sd["model"], sd["optimizer"]
        if self.partition is not None:
            model = self.partition.local_state_dict(model)
            optimizer = self.partition.local_optimizer_state(optimizer, self._param_names())
        self.model.load_state_dict(model, strict=True)
        self.optimizer.load_state_dict(optimizer)
        self.step = int(sd["step"])
        self.graphs.rebind()

    def _param_names(self):
        """The parameters' names in the optimizer's order."""
        return [n for n, _ in self.model.named_parameters()]


def create_train_state(config, model: torch.nn.Module, steps_per_epoch: int,
                       partition=None) -> TrainState:
    schedule = make_lr_schedule(config, steps_per_epoch)
    return TrainState(model, make_optimizer(model, schedule(0)), schedule, partition=partition)
