"""Evaluation metrics and dataset statistics: the port of
eoe_tpu/ops/metrics.py.

  * ROC / PRC curves, AUROC and average precision on the host (numpy, tie
    handling identical to sklearn);
  * ``auroc_torch``, AUROC as a torch op on whatever device its tensors lie
    on: the Mann-Whitney U with tie-averaged ranks, a weights mask, and NaN
    when one class is absent (the JAX package's ``auroc_jax``);
  * ``RunningStats`` (streaming per-channel mean and std) and
    ``channel_stats`` (one pass over an image array), both with the unbiased
    (n - 1) std and uint8 scaled by 1/255.

Label convention: anomalous == 1 is the positive class.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


class ROC(NamedTuple):
    tpr: np.ndarray
    fpr: np.ndarray
    thresholds: np.ndarray
    auc: float

    def get_score(self):
        return self.auc


class PRC(NamedTuple):
    prec: np.ndarray
    rec: np.ndarray
    thresholds: np.ndarray
    avg_prec: float

    def get_score(self):
        return self.avg_prec


def _binary_clf_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cumulative TP/FP per distinct threshold, descending — sklearn-compatible."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]
    # indices of last occurrence of each distinct score
    distinct = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels == 1)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs) - tps
    return fps, tps, scores[threshold_idxs]


def roc_curve(labels, scores) -> ROC:
    """ROC curve + trapezoidal AUC. Equivalent to sklearn.metrics.roc_curve/auc
    with drop_intermediate=False prepended (0,0)."""
    fps, tps, thr = _binary_clf_curve(labels, scores)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr]
    tpr = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    fpr = fps / fps[-1] if fps[-1] > 0 else np.zeros_like(fps)
    auc = float(_trapezoid(tpr, fpr))
    return ROC(tpr=tpr, fpr=fpr, thresholds=thr, auc=auc)


def precision_recall_curve(labels, scores) -> PRC:
    """PRC + average precision, matching sklearn semantics (AP = sum over
    thresholds of (R_n - R_{n-1}) * P_n)."""
    fps, tps, thr = _binary_clf_curve(labels, scores)
    denom = tps + fps
    prec = np.divide(tps, denom, out=np.zeros_like(tps), where=denom > 0)
    rec = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    ap = float(np.sum(np.diff(np.r_[0.0, rec]) * prec))
    # sklearn returns curves reversed with an appended (p=1, r=0) point
    prec_out = np.r_[prec[::-1], 1.0]
    rec_out = np.r_[rec[::-1], 0.0]
    return PRC(prec=prec_out, rec=rec_out, thresholds=thr[::-1], avg_prec=ap)


def auroc(labels, scores) -> float:
    return roc_curve(labels, scores).auc


def average_precision(labels, scores) -> float:
    return precision_recall_curve(labels, scores).avg_prec


# ---------------------------------------------------------------- AUROC on device


def auroc_torch(labels: torch.Tensor, scores: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AUROC as a Mann-Whitney U rank statistic, a 0-d tensor on the inputs'
    device. With average ranks over ties it equals the trapezoidal AUC.
    ``weights`` masks samples out (with labels < 0); masked samples sort to
    the bottom with -inf scores and take no rank."""
    scores = scores.reshape(-1).float()
    labels = labels.reshape(-1)
    if weights is None:
        weights = torch.ones_like(scores)
    weights = weights.float() * (labels >= 0)
    pos = (labels == 1).float() * weights
    neg = (labels != 1).float() * weights

    masked = torch.where(weights > 0, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(masked, stable=True)
    s_sorted, w_sorted = masked[order], weights[order]
    ranks_raw = torch.cumsum(w_sorted, 0)   # 1-based ranks over the kept samples
    # out-of-place throughout, so that torch.func.vmap batches it
    new_grp = torch.cat([torch.ones_like(s_sorted[:1], dtype=torch.bool),
                         s_sorted[1:] != s_sorted[:-1]])
    grp_id = torch.cumsum(new_grp.long(), 0) - 1
    grp_rank_sum = torch.zeros_like(w_sorted).index_add(0, grp_id, ranks_raw * w_sorted)
    grp_w_sum = torch.zeros_like(w_sorted).index_add(0, grp_id, w_sorted)
    avg_rank = torch.where(grp_w_sum > 0, grp_rank_sum / grp_w_sum.clamp(min=1.0),
                           torch.zeros_like(grp_w_sum))[grp_id]
    ranks = torch.zeros_like(avg_rank).scatter(0, order, avg_rank)

    n_pos, n_neg = pos.sum(), neg.sum()
    u = (ranks * pos).sum() - n_pos * (n_pos + 1.0) / 2.0
    auc = u / (n_pos * n_neg).clamp(min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, float("nan")))


# ---------------------------------------------------------------- running stats


class RunningStats:
    """Streaming per-channel mean and std (Welford's combine of batch
    moments). Add batches of shape (..., channels); ``get_mean`` and
    ``get_std`` return numpy arrays, the std unbiased (n - 1)."""

    def __init__(self):
        self.n = 0.0
        self.mean = None
        self.m2 = None

    def add(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        x = x.reshape(-1, x.shape[-1])
        b_n = x.shape[0]
        b_mean = x.mean(dim=0)
        b_m2 = (x - b_mean).square().sum(dim=0)
        if self.mean is None:
            self.n, self.mean, self.m2 = float(b_n), b_mean, b_m2
            return
        delta = b_mean - self.mean
        tot = self.n + b_n
        self.mean = self.mean + delta * (b_n / tot)
        self.m2 = self.m2 + b_m2 + delta.square() * self.n * b_n / tot
        self.n = tot

    def get_mean(self) -> np.ndarray:
        return self.mean.cpu().numpy()

    def get_std(self) -> np.ndarray:
        return torch.sqrt(self.m2 / max(self.n - 1.0, 1.0)).cpu().numpy()


CHANNEL_STATS_CHUNK = 1024   # images summed in fp32 at a time by channel_stats


def channel_stats(images) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and unbiased std of an (n, h, w, c) uint8 (scaled by
    1/255) or float array or tensor, over every pixel of every image: the
    statistics of the ``normalize`` placeholder. Sums in fp32 per chunk of
    ``CHANNEL_STATS_CHUNK`` images on the data's device, accumulated in
    fp64."""
    x = torch.as_tensor(images)
    n = float(np.prod(x.shape[:-1]))
    s1 = torch.zeros(x.shape[-1], dtype=torch.float64, device=x.device)
    s2 = torch.zeros_like(s1)
    axes = tuple(range(x.ndim - 1))
    for i in range(0, x.shape[0], CHANNEL_STATS_CHUNK):
        xf = x[i:i + CHANNEL_STATS_CHUNK].float()
        if x.dtype == torch.uint8:
            xf = xf / 255.0
        s1 += xf.sum(dim=axes).double()
        s2 += xf.square().sum(dim=axes).double()
    mean = (s1 / n).cpu().numpy()
    var = (s2.cpu().numpy() - n * mean ** 2) / max(n - 1.0, 1.0)
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
