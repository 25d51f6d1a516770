"""The port's device metrics and statistics against the JAX package's:
``auroc_torch`` against ``auroc_jax`` (ties, masks, unlabeled samples, one
class absent) and the host AUROC, ``RunningStats`` and ``channel_stats``
(uint8 and float input) on numpy-seeded data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops import metrics as JM
from eoe_tpu_torch.ops import metrics as M

AUC_TOL = 1e-6
# fp32 sums on the JAX side; see tests/test_torch_datasets.py
STATS_TOL = 2e-5


def _auroc_case(seed, n=200, ties=False, masked=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.normal(size=n).astype(np.float32) + labels * 0.5
    if ties:
        scores = np.round(scores, 1)
    weights = None
    if masked:
        labels[:10] = -1
        weights = (rng.random(n) > 0.2).astype(np.float32)
    return labels, scores, weights


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_auroc_torch_matches_jax(ties, masked):
    labels, scores, weights = _auroc_case(int(ties) * 2 + int(masked), ties=ties, masked=masked)
    tw = None if weights is None else torch.from_numpy(weights)
    ours = M.auroc_torch(torch.from_numpy(labels), torch.from_numpy(scores), tw)
    theirs = JM.auroc_jax(jnp.asarray(labels), jnp.asarray(scores),
                          None if weights is None else jnp.asarray(weights))
    assert ours.shape == () and abs(ours.item() - float(theirs)) <= AUC_TOL
    keep = labels >= 0
    if weights is not None:
        keep &= weights > 0
    assert abs(ours.item() - M.auroc(labels[keep], scores[keep])) <= AUC_TOL


def test_auroc_torch_is_nan_with_one_class():
    labels = np.zeros(20, np.int64)
    scores = np.arange(20, dtype=np.float32)
    ours = M.auroc_torch(torch.from_numpy(labels), torch.from_numpy(scores))
    assert torch.isnan(ours) and np.isnan(float(JM.auroc_jax(jnp.asarray(labels),
                                                             jnp.asarray(scores))))
    labels[3] = 1   # the only positive, masked out
    w = np.ones(20, np.float32)
    w[3] = 0
    assert torch.isnan(M.auroc_torch(torch.from_numpy(labels), torch.from_numpy(scores),
                                     torch.from_numpy(w)))


def test_running_stats_match_jax():
    rng = np.random.default_rng(0)
    ours, theirs = M.RunningStats(), JM.RunningStats()
    for n in (7, 64, 1):
        batch = rng.normal(2.0, 3.0, (n, 5, 3)).astype(np.float32)
        ours.add(batch)
        theirs.add(batch)
    np.testing.assert_allclose(ours.get_mean(), theirs.get_mean(), rtol=1e-6)
    np.testing.assert_allclose(ours.get_std(), theirs.get_std(), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_channel_stats_match_jax(dtype, monkeypatch):
    monkeypatch.setattr(M, "CHANNEL_STATS_CHUNK", 7)   # a last chunk of 2 images
    rng = np.random.default_rng(1)
    images = (rng.integers(0, 256, (30, 16, 16, 3)).astype(dtype) if dtype == np.uint8
              else rng.random((30, 16, 16, 3)).astype(dtype))
    mean, std = M.channel_stats(images)
    jmean, jstd = JM.channel_stats(images)
    np.testing.assert_allclose(mean, jmean, rtol=STATS_TOL)
    np.testing.assert_allclose(std, jstd, rtol=STATS_TOL)
    scale = 255.0 if dtype == np.uint8 else 1.0
    flat = images.astype(np.float64).reshape(-1, 3) / scale
    np.testing.assert_allclose(mean, flat.mean(0), rtol=1e-6)
    np.testing.assert_allclose(std, flat.std(0, ddof=1), rtol=1e-6)    # unbiased
