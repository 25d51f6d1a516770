"""Optimizers and the learning-rate schedule of the trainers, with torch
semantics: the port of eoe_tpu/training/optim.py.

Adam (amsgrad off) for every model but CLIP, SGD with Nesterov momentum 0.9
for CLIP, each with a MultiStep schedule (gamma 0.1). Weight decay is L2 added
to the gradient before the moment updates, which is what ``torch.optim``'s
``weight_decay`` does and what the JAX package rebuilt with optax.
``torch.optim.SGD(momentum=0.9, nesterov=True)`` keeps no dampening and
applies the learning rate after the momentum, as optax's ``trace`` chain does.

A captured CUDA graph of the step (``training.graphs``) replays what the
host computed when it was captured. The rate is a Python float set before
every update, so a graph holds the rates of its capture: the MultiStep
boundaries are whole epochs, so a graph of steps within one epoch holds one
rate, and ``graphs.ResidentSteps`` captures anew where the schedule moves.
Adam counts its updates on the device once ``make_capturable`` has run
(``capturable=True``; SGD keeps no count), which also makes the state the
first update would make. Snapshots store the state as an optimizer that is
not capturable, so that any device loads them.
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

    def rates(self, n: int) -> tuple:
        """The rates of the next ``n`` updates."""
        return tuple(self.schedule(self.count + i) for i in range(n))

    def make_capturable(self):
        """Let a CUDA graph capture the update: Adam's step counts move to
        the parameters' device as fp32 (``torch.optim``'s capturable
        layout), so the bias correction is computed there; and the state
        that the first update would make (SGD's momentum; Adam's count and
        moments) is made now, as zeros in fresh memory. Made by the first
        update, it would take blocks that the step's activations had just
        freed and keep their segments reserved, where the capture, which
        allocates from its own pool, cannot use them: a program sized for
        one step's activations then needs more than the card has. The first
        update gives the same numbers either way (SGD: 0 * momentum +
        gradient for a cloned gradient)."""
        fresh = True
        for group in self.optimizer.param_groups:
            adam = "capturable" in group   # SGD keeps no count
            if adam:
                group["capturable"] = True
            for p in group["params"]:
                st = self.optimizer.state[p]
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
                if st or not (adam or group["momentum"]):
                    continue
                if fresh and p.is_cuda:   # free the cached blocks the state could take
                    torch.cuda.synchronize(p.device)
                    torch.cuda.empty_cache()
                fresh = False
                if adam:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                else:
                    st["momentum_buffer"] = torch.zeros_like(p)

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        sd["param_groups"] = [{**g, "capturable": False} if "capturable" in g else g
                              for g in sd["param_groups"]]
        return {"optimizer": sd, "count": self.count}

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
