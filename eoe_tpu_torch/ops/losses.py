"""Anomaly-detection objectives of the trainers: the port of
eoe_tpu/ops/losses.py (HSC, BCE, focal, DSVDD, DSAD, AE and CLIP).

Each objective provides
  * ``loss(features, labels, center, *, nominal_label=0, weights=None)`` -- the
    scalar training loss over a batch of model outputs,
  * ``score(features, center, *, nominal_label=0)`` -- per-sample anomaly
    scores of shape ``(n,)``; larger is more anomalous.
The AE objective's loss and score also take ``inputs=``, the images the
model reconstructs.

Every loss takes an optional 0/1 ``weights`` mask per sample (padding slots
of a ragged batch, unlabeled samples) and averages over the kept samples, as
the JAX package does.
"""

from typing import Optional

import torch

_EPS = 1e-9


def _masked_mean(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return x.mean()
    weights = weights.to(x.dtype)
    return (x * weights).sum() / weights.sum().clamp(min=1.0)


def _pseudo_huber(features: torch.Tensor) -> torch.Tensor:
    """sqrt(||f||^2 + 1) - 1, the HSC radial distance."""
    sq = features.reshape(features.shape[0], -1).square().sum(dim=-1)
    return torch.sqrt(sq + 1.0) - 1.0


def hsc_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
              nominal_label: int = 0, **_) -> torch.Tensor:
    return 1.0 - torch.exp(-_pseudo_huber(features))


def hsc_loss(features: torch.Tensor, labels: torch.Tensor,
             center: Optional[torch.Tensor] = None, *, nominal_label: int = 0,
             weights: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    dists = _pseudo_huber(features)
    scores = 1.0 - torch.exp(-dists)
    losses = torch.where(labels == nominal_label, dists, -torch.log(scores + _EPS))
    return _masked_mean(losses, weights)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
              nominal_label: int = 0, **_) -> torch.Tensor:
    scores = torch.sigmoid(features.reshape(features.shape[0]))
    return scores if nominal_label == 0 else 1.0 - scores


def bce_loss(features: torch.Tensor, labels: torch.Tensor,
             center: Optional[torch.Tensor] = None, *, nominal_label: int = 0,
             weights: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    logits = features.reshape(features.shape[0])
    return _masked_mean(_bce_with_logits(logits, labels.to(logits.dtype)), weights)


def focal_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
                nominal_label: int = 0, **_) -> torch.Tensor:
    return bce_score(features, center, nominal_label=nominal_label)


def focal_loss(features: torch.Tensor, labels: torch.Tensor,
               center: Optional[torch.Tensor] = None, *, nominal_label: int = 0,
               gamma: float = 2.0, eps: float = 1e-7,
               weights: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    logits = features.reshape(features.shape[0])
    bce = _bce_with_logits(logits, labels.to(logits.dtype))
    pt = torch.exp(-bce).clamp(eps, 1.0 - eps)
    return _masked_mean((1.0 - pt) ** gamma * bce, weights)


def dsvdd_score(features: torch.Tensor, center: torch.Tensor, *, nominal_label: int = 0,
                **_) -> torch.Tensor:
    return (features - center).square().sum(dim=-1)


def dsvdd_loss(features: torch.Tensor, labels: torch.Tensor, center: torch.Tensor, *,
               nominal_label: int = 0, weights: Optional[torch.Tensor] = None,
               **_) -> torch.Tensor:
    return _masked_mean((features - center).square().sum(dim=-1), weights)


def dsvdd_center(feature_sums: torch.Tensor, count, *, eps: float = 1e-1) -> torch.Tensor:
    """The DSVDD centre from the summed features of the normal samples: their
    mean, with entries of magnitude under ``eps`` pushed to +-eps by their
    sign (exact zeros stay zero, as in the JAX package)."""
    center = feature_sums / max(float(count), 1.0)
    small = center.abs() < eps
    center = torch.where(small & (center < 0), torch.full_like(center, -eps), center)
    return torch.where(small & (center > 0), torch.full_like(center, eps), center)


def dsad_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
               nominal_label: int = 0, **_) -> torch.Tensor:
    return hsc_score(features, center, nominal_label=nominal_label)


def dsad_loss(features: torch.Tensor, labels: torch.Tensor,
              center: Optional[torch.Tensor] = None, *, nominal_label: int = 0,
              weights: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    sq = features.reshape(features.shape[0], -1).square().sum(dim=-1)
    losses = torch.where(labels == nominal_label, sq, 1.0 / (sq + _EPS))
    return _masked_mean(losses, weights)


def ae_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
             inputs: torch.Tensor, nominal_label: int = 0, **_) -> torch.Tensor:
    return (features - inputs).reshape(features.shape[0], -1).square().sum(dim=-1)


def ae_loss(features: torch.Tensor, labels: torch.Tensor,
            center: Optional[torch.Tensor] = None, *, inputs: torch.Tensor,
            nominal_label: int = 0, weights: Optional[torch.Tensor] = None,
            **_) -> torch.Tensor:
    return _masked_mean(ae_score(features, inputs=inputs), weights)


def clip_score(image_features: torch.Tensor, text_features: torch.Tensor, *,
               nominal_label: int = 0, **_) -> torch.Tensor:
    """Softmax over 100 x cosine similarity to the prompts; the probability of
    the last (anomaly) prompt."""
    t = text_features / text_features.norm(dim=-1, keepdim=True)
    v = image_features / image_features.norm(dim=-1, keepdim=True)
    return torch.softmax(100.0 * v @ t.T, dim=-1)[:, -1]


def clip_loss(image_features: torch.Tensor, labels: torch.Tensor,
              text_features: torch.Tensor, *, nominal_label: int = 0,
              ad_mode: str = "one_vs_rest", weights: Optional[torch.Tensor] = None,
              **_) -> torch.Tensor:
    """Prompt-contrastive AD loss. one_vs_rest: normal samples maximise the
    log-softmax of prompt 0, anomalous (OE) samples that of the last (anomaly)
    prompt; leave_one_out: normal samples maximise the best non-anomaly
    prompt. ``text_features`` are used as they are (normalised once by the
    prompt centre)."""
    anom_label = 1 - nominal_label
    v = image_features / image_features.norm(dim=-1, keepdim=True)
    logp = torch.log_softmax(100.0 * v @ text_features.T, dim=-1)
    aloss = logp[:, -1]
    if ad_mode == "one_vs_rest":
        nloss = logp[:, 0]
    elif ad_mode == "leave_one_out":
        nloss = logp[:, :-1].amax(dim=-1)
    else:
        raise NotImplementedError(f"ad_mode {ad_mode} unknown")
    losses = -torch.where(labels == anom_label, aloss, nloss)
    return _masked_mean(losses, weights)


class Objective:
    """The loss and score of one AD objective and what they need."""

    def __init__(self, name: str, loss_fn, score_fn, *, needs_center: bool = False,
                 clf_head: bool = False, uses_inputs: bool = False, is_clip: bool = False):
        self.name = name
        self.loss = loss_fn
        self.score = score_fn
        self.needs_center = needs_center  # DSVDD center / CLIP text-feature matrix
        self.clf_head = clf_head          # the model needs a one-neuron head
        self.uses_inputs = uses_inputs    # loss and score need the raw inputs (AE)
        self.is_clip = is_clip

    def __repr__(self):
        return f"Objective({self.name})"


OBJECTIVES = {
    "hsc": Objective("hsc", hsc_loss, hsc_score),
    "bce": Objective("bce", bce_loss, bce_score, clf_head=True),
    "focal": Objective("focal", focal_loss, focal_score, clf_head=True),
    "dsvdd": Objective("dsvdd", dsvdd_loss, dsvdd_score, needs_center=True),
    "dsad": Objective("dsad", dsad_loss, dsad_score),
    "ae": Objective("ae", ae_loss, ae_score, uses_inputs=True),
    "clip": Objective("clip", clip_loss, clip_score, needs_center=True, is_clip=True),
}
