"""Train state: the model, Adam, the StepLR schedule and the step count
(polardepth_tpu/train/state.py:20-50; reference trainer.py:238-240).

``torch.optim.Adam`` with its defaults is optax's ``adam`` (betas 0.9 and
0.999, eps 1e-8, no eps inside the root).  The schedule multiplies the
learning rate by gamma at every scheduler_step_size-epoch boundary short of
num_epochs, counted in optimizer steps, as ``step_lr_schedule`` places them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from polardepth_tpu_torch.config import Config


def step_lr_boundaries(steps_per_epoch: int, scheduler_step_size: int,
                       num_epochs: int) -> list[int]:
    """The optimizer steps from which the learning rate drops by gamma."""
    return [e * steps_per_epoch
            for e in range(scheduler_step_size, num_epochs,
                           scheduler_step_size)]


def step_lr_factor(step: int, boundaries, gamma: float) -> float:
    """The learning rate of optimizer step ``step`` (0-based) over the base:
    gamma to the number of boundaries at or before it."""
    return gamma ** sum(step >= b for b in boundaries)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model: nn.Module, cfg: Config,
                       steps_per_epoch: int = 1) -> TrainState:
    """Adam over every parameter of model at cfg.learning_rate, with the
    StepLR(cfg.scheduler_step_size epochs, cfg.scheduler_gamma) schedule
    advanced once per train step."""
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    boundaries = step_lr_boundaries(steps_per_epoch, cfg.scheduler_step_size,
                                    cfg.num_epochs)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda i: step_lr_factor(i, boundaries, cfg.scheduler_gamma))
    return TrainState(model, optimizer, scheduler)


def apply_gradients(state: TrainState) -> None:
    """One Adam update from the gradients on the parameters, then the
    schedule's next learning rate and the step count."""
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
