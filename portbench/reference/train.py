"""Plain PyTorch training steps and optimizers of the EOE trainer.

A step takes a normal half and an OE half of raw uint8 images, each through
the training stack with its draws (``augment.apply``), runs the model on
their concatenation, averages the per-sample losses over the real slots
(weights ``w`` of both halves, times ``labels >= 0``) and updates the
trainable parameters:

* SGD with Nesterov momentum 0.9 and L2 weight decay added to the gradient:
  ``d = g + wd p``; ``buf = d`` at the first step, else ``0.9 buf + d``;
  ``p -= lr (d + 0.9 buf)``;
* Adam (0.9, 0.999, eps 1e-8), L2 weight decay added to the gradient, the
  bias-corrected moments.

``first_gradient`` is what the optimizer receives at the first step (``d``
for SGD, ``g + wd p`` for Adam). Rows of the batch are taken in blocks where
the model treats them independently (``row_block``); a model with batch
norm runs the whole batch at once.
"""

from typing import Callable, Dict, List, Optional, Sequence

import torch

from portbench.reference import augment


class Optimizer:
    def __init__(self, kind: str, lr: float, wd: float):
        assert kind in ("sgd", "adam"), kind
        self.kind, self.lr, self.wd = kind, lr, wd
        self.t = 0
        self.state: Dict[str, dict] = {}

    def received(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return g + self.wd * p if self.wd else g

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        for name, g in grads.items():
            p = params[name]
            d = self.received(p, g)
            st = self.state.setdefault(name, {})
            if self.kind == "sgd":
                buf = d.clone() if "buf" not in st else st["buf"].mul_(0.9).add_(d)
                st["buf"] = buf
                p.sub_(self.lr * (d + 0.9 * buf))
            else:
                m = st.setdefault("m", torch.zeros_like(p)).mul_(0.9).add_(0.1 * d)
                v = st.setdefault("v", torch.zeros_like(p)).mul_(0.999).add_(0.001 * d * d)
                mhat = m / (1 - 0.9 ** self.t)
                vhat = v / (1 - 0.999 ** self.t)
                p.sub_(self.lr * mhat / (vhat.sqrt() + 1e-8))


def run_steps(forward: Callable, loss_terms: Callable, score: Callable,
              params: Dict[str, torch.Tensor], trainable: Callable[[str], bool],
              batches: Sequence[dict], stacks: dict, optimizer: Optimizer, centre=None,
              row_block: Optional[int] = None, stats=None) -> dict:
    """Train ``params`` (float32, updated in place) on ``batches``, each
    {xn, ln, xo, lo, w, draws_n, draws_o} (and ``w_o``, the OE half's weights
    where they differ from ``w``); ``stacks`` {specs, guard_n,
    guard_o}. Returns {"losses": [...], "scores": [per-sample anomaly scores
    of each step's forward pass], "first_gradient": {name: tensor}}."""
    names = [n for n in params if trainable(n)]
    losses: List[float] = []
    scores: List[torch.Tensor] = []
    first = None
    for b in batches:
        xn = augment.apply(b["xn"], stacks["specs"], b["draws_n"], stacks["guard_n"], stats)
        xo = augment.apply(b["xo"], stacks["specs"], b["draws_o"], stacks["guard_o"], stats)
        x = torch.cat([xn, xo])
        labels = torch.cat([b["ln"], b["lo"]])
        w = torch.cat([b["w"], b.get("w_o", b["w"])]).float() * (labels >= 0).float()
        total = w.sum().clamp(min=1.0)
        leaves = {n: params[n].detach().clone().requires_grad_(True) for n in names}
        full = {**params, **leaves}
        grads = {n: torch.zeros_like(params[n]) for n in names}
        loss = 0.0
        step = row_block or len(x)
        step_scores = []
        for i in range(0, len(x), step):
            feats = forward(full, x[i:i + step])
            part = (loss_terms(feats, labels[i:i + step], centre) * w[i:i + step]).sum() / total
            got = torch.autograd.grad(part, [leaves[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            loss += float(part.detach())
            step_scores.append(score(feats.detach(), centre))
        losses.append(loss)
        scores.append(torch.cat(step_scores))
        if first is None:
            first = {n: optimizer.received(params[n], grads[n]).clone() for n in names}
        optimizer.step(params, grads)
    return {"losses": losses, "scores": scores, "first_gradient": first}
