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
"""

from __future__ import annotations

from typing import Callable

import torch


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
    needs."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.step = step

    def apply_gradients(self) -> None:
        """One Adam step at the schedule's rate for the current step."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def create_train_state(config, model: torch.nn.Module, steps_per_epoch: int) -> TrainState:
    schedule = make_lr_schedule(config, steps_per_epoch)
    return TrainState(model, make_optimizer(model, schedule(0)), schedule)
