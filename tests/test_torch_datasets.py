"""The port's dataset layer against the JAX package's: the sampler's index
plans bit for bit over three epochs, binary targets, normal/anomalous
counts, subsets and the class-label tables."""

import numpy as np
import pytest

from eoe_tpu import datasets as jax_datasets
from eoe_tpu.datasets import bases as JB
from eoe_tpu_torch import datasets as D
from eoe_tpu_torch.datasets import bases as B


@pytest.mark.parametrize("n_normal,n_oe,batch", [
    (50, 200, 16),   # OE longer than the normal set
    (50, 12, 16),    # OE shorter: its list is tiled
    (10, 0, 16),     # no OE, one padded batch
    (64, 64, 16)])   # exact batches
def test_sampler_plans_equal_jax(n_normal, n_oe, batch):
    ours = B.BalancedEpochSampler(n_normal, n_oe, batch, seed=1234)
    theirs = JB.BalancedEpochSampler(n_normal, n_oe, batch, seed=1234)
    assert ours.steps == theirs.steps
    for _ in range(3):
        for a, b in zip(ours.epoch(), theirs.epoch()):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _datasets(mod, limit=float("inf"), seed=0):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (40, 8, 8, 3), dtype=np.uint8)
    y = np.arange(40) % 4
    y[::7] = -1  # unlabeled samples
    kw = dict(root="", train_specs=[], test_specs=[], n_classes=4, raw_shape=(8, 8, 3))
    normal = mod.GenericADDataset(mod.ArraySource(x, y), mod.ArraySource(x[:20], y[:20]),
                                  normal_classes=(0, 2), nominal_label=0,
                                  limit_samples=limit, rng=np.random.default_rng(seed), **kw)
    oe = mod.GenericADDataset(mod.ArraySource(x, y), None, normal_classes=(1, 3),
                              nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


@pytest.mark.parametrize("limit", [float("inf"), 5, [1, 4, 9]])
def test_targets_and_counts_equal_jax(limit):
    ours, theirs = _datasets(B, limit), _datasets(JB, limit)
    np.testing.assert_array_equal(ours.train_set.indices, theirs.train_set.indices)
    np.testing.assert_array_equal(ours.train_set.gather_all(), theirs.train_set.gather_all())
    for part in ("normal", "oe"):
        o, t = getattr(ours, part), getattr(theirs, part)
        for subset in ("train_set", "test_set"):
            if getattr(t, subset) is None:
                continue
            np.testing.assert_array_equal(o.binary_targets(getattr(o, subset)),
                                          t.binary_targets(getattr(t, subset)))
    for train in (True, False):
        assert ours.n_normal_anomalous(train) == theirs.n_normal_anomalous(train)
    assert ours.normal.outlier_classes == theirs.normal.outlier_classes
    assert ours.raw_shape == theirs.raw_shape and ours.ds_statistics is None


def test_normalize_placeholder_needs_statistics():
    x = np.zeros((4, 8, 8, 3), np.uint8)
    kw = dict(root="", train_specs=["normalize"], test_specs=[], n_classes=2,
              raw_shape=(8, 8, 3), normal_classes=(0,), nominal_label=0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        B.GenericADDataset(B.ArraySource(x, np.zeros(4)), None, **kw)
    ds = B.GenericADDataset(B.ArraySource(x, np.zeros(4)), None,
                            ds_statistics={"mean": [0.5] * 3, "std": [0.2] * 3}, **kw)
    assert ds.ds_statistics == {"mean": [0.5] * 3, "std": [0.2] * 3, "mode": 0}


def test_label_tables_equal_jax():
    for name in D.STR_LABELS:
        assert D.str_labels(name) == jax_datasets.str_labels(name)
        assert D.no_classes(name) == jax_datasets.no_classes(name)
    with pytest.raises(NotImplementedError):
        D.str_labels("cub")
