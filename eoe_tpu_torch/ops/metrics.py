"""Evaluation metrics on the host: ROC / PRC curves, AUROC, average
precision (numpy, tie handling identical to sklearn). The port of the host
part of eoe_tpu/ops/metrics.py; the on-device ``auroc_jax`` is not ported yet.

Label convention: anomalous == 1 is the positive class.
"""

from typing import NamedTuple, Tuple

import numpy as np

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
