"""Anomaly scores of the ported objectives: the score half of
eoe_tpu/ops/losses.py for HSC and CLIP. The losses come with the training
slice.

``score(features, center, *, nominal_label=0)`` returns per-sample anomaly
scores of shape ``(n,)``; larger is more anomalous.
"""

from typing import Optional

import torch


def _pseudo_huber(features: torch.Tensor) -> torch.Tensor:
    """sqrt(||f||^2 + 1) - 1, the HSC radial distance."""
    sq = features.reshape(features.shape[0], -1).square().sum(dim=-1)
    return torch.sqrt(sq + 1.0) - 1.0


def hsc_score(features: torch.Tensor, center: Optional[torch.Tensor] = None, *,
              nominal_label: int = 0, **_) -> torch.Tensor:
    return 1.0 - torch.exp(-_pseudo_huber(features))


def clip_score(image_features: torch.Tensor, text_features: torch.Tensor, *,
               nominal_label: int = 0, **_) -> torch.Tensor:
    """Softmax over 100 x cosine similarity to the prompts; the probability of
    the last (anomaly) prompt."""
    t = text_features / text_features.norm(dim=-1, keepdim=True)
    v = image_features / image_features.norm(dim=-1, keepdim=True)
    return torch.softmax(100.0 * v @ t.T, dim=-1)[:, -1]


class Objective:
    """The score of one AD objective and what it needs."""

    def __init__(self, name: str, score_fn, *, needs_center: bool = False):
        self.name = name
        self.score = score_fn
        self.needs_center = needs_center  # DSVDD center / CLIP text-feature matrix

    def __repr__(self):
        return f"Objective({self.name})"


OBJECTIVES = {
    "hsc": Objective("hsc", hsc_score),
    "clip": Objective("clip", clip_score, needs_center=True),
}
