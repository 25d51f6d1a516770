"""Optimizers and the learning-rate schedule of the trainers, with torch
semantics: the port of eoe_tpu/training/optim.py.

Adam (amsgrad off) for every model but CLIP, SGD with Nesterov momentum 0.9
for CLIP, each with a MultiStep schedule (gamma 0.1). Weight decay is L2 added
to the gradient before the moment updates, which is what ``torch.optim``'s
``weight_decay`` does and what the JAX package rebuilt with optax.
``torch.optim.SGD(momentum=0.9, nesterov=True)`` keeps no dampening and
applies the learning rate after the momentum, as optax's ``trace`` chain does.
"""

from typing import Callable, Iterable, Sequence

import torch

Schedule = Callable[[int], float]


def multistep_lr(base_lr: float, milestones: Sequence[int], steps_per_epoch: int,
                 gamma: float = 0.1) -> Schedule:
    """MultiStepLR over epochs, as a function of the optimizer's update count
    (0 for the first update). The rate drops by ``gamma`` from update
    ``m * steps_per_epoch`` on, inclusive, as optax's
    ``piecewise_constant_schedule`` does."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate follows ``schedule``
    of its update count, set before every update."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_optimizer(kind: str, params: Iterable[torch.nn.Parameter], base_lr: float,
                   weight_decay: float, milestones: Sequence[int],
                   steps_per_epoch: int) -> ScheduledOptimizer:
    """``kind``: "sgd" (Nesterov momentum 0.9) or "adam". ``params`` may be
    empty (a frozen model without a head): the updates are then no-ops."""
    params = [{"params": list(params)}]
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=0.9, nesterov=True,
                              weight_decay=weight_decay)
    elif kind == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return ScheduledOptimizer(opt, multistep_lr(base_lr, milestones, steps_per_epoch))
