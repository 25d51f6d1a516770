"""The port's dataset layer against the JAX package's: the sampler's index
plans bit for bit over three epochs, binary targets, normal/anomalous
counts, subsets, the class-label tables, the statistics of the ``normalize``
placeholders and their cache, and ``load_dataset`` by name on the
synthetic data (``EOE_TPU_FAKE_DATA=1``)."""

import json

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


# The JAX package sums the pixels in fp32 (one XLA reduction): on the
# synthetic CIFAR classes its mean is up to 2.5e-6 and its std up to 8.6e-6
# (relative) off an fp64 numpy reference; the port accumulates per-chunk
# fp32 sums in fp64 and stays within 4e-7 of it.
STATS_TOL = 2e-5
EXACT_TOL = 1e-6


def _stats_close(ours, theirs):
    assert ours["mode"] == theirs["mode"]
    for key in ("mean", "std"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=STATS_TOL, atol=1e-7)


def _exact_stats(images):
    f = images.astype(np.float64).reshape(-1, images.shape[-1]) / 255.0
    return f.mean(0), f.std(0, ddof=1)


def test_normalize_placeholder_needs_statistics():
    """Without ``ds_statistics`` the placeholder takes its statistics from the
    normal train split, equal to the JAX package's; given ones are kept."""
    x = np.random.default_rng(3).integers(0, 256, (12, 8, 8, 3), dtype=np.uint8)
    y = np.arange(12) % 2
    kw = dict(root="", train_specs=["normalize"], test_specs=[], n_classes=2,
              raw_shape=(8, 8, 3), normal_classes=(0,), nominal_label=0)
    ours = B.GenericADDataset(B.ArraySource(x, y), None, **kw)
    theirs = JB.GenericADDataset(JB.ArraySource(x, y), None, **kw)
    _stats_close(ours.ds_statistics, theirs.ds_statistics)
    for got, want in zip((ours.ds_statistics["mean"], ours.ds_statistics["std"]),
                         _exact_stats(x[y == 0])):
        np.testing.assert_allclose(got, want, rtol=EXACT_TOL)
    ds = B.GenericADDataset(B.ArraySource(x, y), None,
                            ds_statistics={"mean": [0.5] * 3, "std": [0.2] * 3}, **kw)
    assert ds.ds_statistics == {"mean": [0.5] * 3, "std": [0.2] * 3, "mode": 0}


def test_gcn_statistics_and_cache_equal_jax(tmp_path):
    """The GCN mode's statistics (the range of the L1-normalised images), and
    ``stats_cache.json``: the port writes the JAX package's file and reads
    it back (and the JAX package reads the port's)."""
    x = np.random.default_rng(4).integers(0, 256, (10, 8, 8, 3), dtype=np.uint8)
    kw = dict(train_specs=[], test_specs=[], n_classes=2, raw_shape=(8, 8, 3),
              normal_classes=(1,), nominal_label=0)
    stats = {}
    for name, mod in (("port", B), ("jax", JB)):
        root = tmp_path / name
        ds = mod.GenericADDataset(mod.ArraySource(x, np.ones(10)), None, root=str(root), **kw)
        for specs in (["gcn-normalize"], ["normalize"]):
            ds.train_specs = specs
            stats[name, specs[0]] = ds._extract_stats().to_json()
        stats[name, "file"] = json.loads((root / "stats_cache.json").read_text())
    for specs in ("gcn-normalize", "normalize"):
        _stats_close(stats["port", specs], stats["jax", specs])
    assert stats["port", "file"].keys() == stats["jax", "file"].keys()
    # a cached entry wins over the data
    cached = B.GenericADDataset(B.ArraySource(np.zeros_like(x), np.ones(10)), None,
                                root=str(tmp_path / "jax"), **dict(kw, train_specs=["normalize"]))
    _stats_close(cached.ds_statistics, stats["jax", "normalize"])


def _by_name(mod, name, oe_name, seed, **kw):
    return mod.load_dataset(name, "", [1], 0, ["normalize"], ["normalize"], None, oe_name,
                            rng=np.random.default_rng([seed, 1, 0]), **kw)


@pytest.mark.parametrize("name,oe_name,kw", [
    ("cifar10", "cifar100", dict(oe_limit_classes=3)),
    ("cifar10", "cifar100", dict(oe_limit_samples=50)),
    ("fmnist", "mnist", dict(oe_limit_classes=2, oe_limit_samples=30)),
    ("emnist", None, {}),
])
def test_load_dataset_by_name_equals_jax(name, oe_name, kw, monkeypatch):
    """The same subsets, targets, OE classes and statistics as the JAX
    package's factory, from the same rng."""
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    ours, theirs = _by_name(D, name, oe_name, 5, **kw), _by_name(jax_datasets, name, oe_name, 5,
                                                                 **kw)
    parts = ("normal", "oe") if oe_name else (None,)
    for part in parts:
        o = getattr(ours, part) if part else ours
        t = getattr(theirs, part) if part else theirs
        assert type(o).__name__ == type(t).__name__
        assert o.normal_classes == t.normal_classes and o.nominal_label == t.nominal_label
        assert o.raw_shape == t.raw_shape
        _stats_close(o.ds_statistics, t.ds_statistics)
        if part != "oe":
            for got, want in zip((o.ds_statistics["mean"], o.ds_statistics["std"]),
                                 _exact_stats(o.train_set.gather_all())):
                np.testing.assert_allclose(got, want, rtol=EXACT_TOL)
        for subset in ("train_set", "test_set"):
            so, st = getattr(o, subset), getattr(t, subset)
            np.testing.assert_array_equal(so.indices, st.indices)
            np.testing.assert_array_equal(so.gather_all(), st.gather_all())
            np.testing.assert_array_equal(o.binary_targets(so), t.binary_targets(st))
    if oe_name:
        assert ours.oe.ds_statistics == ours.normal.ds_statistics   # the normal set's
        assert len(ours.oe.normal_classes) == kw.get("oe_limit_classes",
                                                     D.no_classes(oe_name))


def test_load_dataset_refuses_what_is_not_ported():
    """Every registry name resolves to the JAX package's dataset class (by
    name); ImageNet-1k is refused as the normal set, being OE only; the
    registry's sizes, class counts and flags are the JAX package's."""
    for name in jax_datasets.DS_CHOICES:
        assert D._resolve_class(name).__name__ == jax_datasets._resolve_class(name).__name__
    with pytest.raises(ValueError, match="only be used as OE"):
        D.load_dataset("imagenetoe", "", [0], 0, [], [])
    msm = D.MSM.load("blur+train_oe--M3")
    assert str(msm) == str(jax_datasets.MSM.load("blur+train_oe--M3"))
    assert msm.get_spec() == jax_datasets.MSM.load("blur+train_oe--M3").get_spec()
    # MSMs apply now: tests/test_torch_datasets.py::test_load_dataset_msms_match_jax
    ds = D.load_dataset("cifar10", "", [0], 0, [], [], None, "cifar100", msms=[msm])
    assert ds.oe.train_conditional == [(0, [msm.get_spec()], [msm.get_spec()])]
    for specs, name in (([{"op": "resize", "size": 64}], "cifar10"), ([], "mnist"),
                        (["normalize"], "imagenet")):
        assert D.get_raw_shape(specs, name) == jax_datasets.get_raw_shape(specs, name)
    for name, entry in jax_datasets.DS_CHOICES.items():
        ours = D.DS_CHOICES[name]
        assert [ours[k] for k in ("default_size", "no_classes", "oe_only", "str_labels")] == \
            [entry[k] for k in ("default_size", "no_classes", "oe_only", "str_labels")]


def test_label_tables_equal_jax(monkeypatch):
    """The label tables; CUB's names (placeholders before a CUB dataset is
    built, as in the JAX package: tests/test_torch_folder_datasets.py holds
    the real ones); the custom dataset's classes depend on its folders."""
    from eoe_tpu.datasets import cub as jax_cub
    from eoe_tpu_torch.datasets import cub as port_cub
    for name in D.STR_LABELS:
        assert D.str_labels(name) == jax_datasets.str_labels(name)
        assert D.no_classes(name) == jax_datasets.no_classes(name)
    monkeypatch.setattr(port_cub, "_CUB_LABELS_CACHE", [])
    monkeypatch.setattr(jax_cub, "_CUB_LABELS_CACHE", [])
    assert D.str_labels("cub") == jax_datasets.str_labels("cub")
    assert D.no_classes("cub") == jax_datasets.no_classes("cub") == 200
    for fn in (D.str_labels, D.no_classes):
        with pytest.raises(ValueError, match="depend"):
            fn("custom")


MSM_CASES = ["lpf+train_nominal--M4", "blur+train_oe--M2", "hpf+test_nominal--M8",
             "sharpen+test_anomalous--M3"]


@pytest.mark.parametrize("msm", MSM_CASES)
def test_load_dataset_msms_match_jax(msm, monkeypatch):
    """Each dataset part's MSM becomes the same conditionals as in the JAX
    package, and they compute the same images from the same raw images and
    labels (1e-5 of max(1, the largest magnitude))."""
    import jax.numpy as jnp
    import torch
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    ours = _by_name(D, "cifar10", "cifar100", 5, msms=[D.MSM.load(msm)])
    theirs = _by_name(jax_datasets, "cifar10", "cifar100", 5, msms=[jax_datasets.MSM.load(msm)])
    checked = 0
    for part, subset, cond in (("normal", "train_set", "train_conditional"),
                               ("normal", "test_set", "test_conditional"),
                               ("oe", "train_set", "train_conditional")):
        o, t = getattr(ours, part), getattr(theirs, part)
        assert getattr(o, cond) == list(getattr(t, cond) or ())
        so, st = getattr(o, subset), getattr(t, subset)
        images, labels = so.gather_all()[:24], o.binary_targets(so)[:24]
        np.testing.assert_array_equal(images, st.gather_all()[:24])
        got = getattr(o, cond + "_pipeline")(torch.from_numpy(images), torch.from_numpy(labels))
        want = np.asarray(getattr(t, cond + "_pipeline")(jnp.asarray(images),
                                                          jnp.asarray(labels)))
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))
        checked += bool(getattr(o, cond))
    assert checked == 1   # one part only takes the MSM


def test_tinyimages_fake_bytes_equal_jax(monkeypatch):
    """``EOE_TPU_FAKE_DATA=1`` gives the JAX package's 512 images byte for
    byte, also as the OE set of CIFAR-10, subsampled from the same rng."""
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    kw = dict(oe_limit_samples=100)
    ours = _by_name(D, "cifar10", "tinyimages", 3, **kw)
    theirs = _by_name(jax_datasets, "cifar10", "tinyimages", 3, **kw)
    assert type(ours.oe).__name__ == "ADTinyImages" and len(ours.oe.train_set) == 100
    assert len(ours.oe.train_set.source) == 512 and ours.oe.test_set is None
    np.testing.assert_array_equal(ours.oe.train_set.indices, theirs.oe.train_set.indices)
    np.testing.assert_array_equal(ours.oe.train_set.gather_all(),
                                  theirs.oe.train_set.gather_all())
    np.testing.assert_array_equal(ours.oe.train_set.source.images,
                                  theirs.oe.train_set.source.images)


def _write_tiny_bin(root, n=20):
    folder = root / "tinyimages"
    folder.mkdir(parents=True)
    raw = np.random.default_rng(6).integers(0, 256, n * 3072, dtype=np.uint8)
    (folder / "tiny_images.bin").write_bytes(raw.tobytes())
    (folder / "80mn_cifar_idxs.txt").write_text("1\n5\n7\n99\n")   # 1-based; 99 past the end


def test_tinyimages_bin_equals_jax(tmp_path, monkeypatch):
    """The memory-mapped bin: the same surviving indices (duplicates listed
    1-based, entries past a partial bin's end ignored) and the same images."""
    from eoe_tpu.datasets.tinyimages import ADTinyImages as JaxTiny
    from eoe_tpu_torch.datasets.tinyimages import ADTinyImages
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "0")
    _write_tiny_bin(tmp_path)
    args = ([0], 1, [], [], (32, 32, 3))
    ours, theirs = ADTinyImages(str(tmp_path), *args), JaxTiny(str(tmp_path), *args)
    assert not ours.train_set.source.resident
    np.testing.assert_array_equal(ours.train_set.source.valid, theirs.train_set.source.valid)
    assert len(ours.train_set) == 17
    np.testing.assert_array_equal(ours.train_set.gather_all(), theirs.train_set.gather_all())
    with pytest.raises(FileNotFoundError, match="tiny_images.bin"):
        ADTinyImages(str(tmp_path / "elsewhere"), *args)


def test_streaming_oe_trains(tmp_path, monkeypatch):
    """A streaming OE source (the bin) trains: its batches are gathered on
    the host step by step, after the training preview's one gather; the
    normal split lives on the device."""
    import torch
    from eoe_tpu_torch.datasets.tinyimages import ADTinyImages
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.utils.logger import Logger
    _write_tiny_bin(tmp_path)
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    normal = D.load_dataset("cifar10", "", [0], 0, ["normalize"], ["normalize"])
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "0")
    oe = ADTinyImages(str(tmp_path), [0], 1, ["normalize"], ["normalize"], (32, 32, 3),
                      ds_statistics=normal.ds_statistics)
    trainer = TRAINER["hsc"](model=CNN32(rep_dim=16), train_specs=["normalize"],
                             test_specs=["normalize"], dataset="cifar10", oe_dataset=None,
                             datapath="", logger=Logger(str(tmp_path / "run"), noname=True),
                             epochs=2, lr=1e-3, wdk=0.0, milestones=[], batch_size=8,
                             device="cpu")
    trainer.ds = D.bases.CombinedDataset(normal, oe)
    gathered = []
    real_gather = oe.train_set.gather
    monkeypatch.setattr(oe.train_set, "gather",
                        lambda pos: gathered.append(len(pos)) or real_gather(pos))
    _, res = trainer.run(run_classes=[0])
    steps = 2 * -(-len(normal.train_set) // 8)
    assert gathered == [min(40, len(oe.train_set))] + [8] * steps
    assert len(trainer.step_losses) == steps and np.isfinite(trainer.step_losses).all()
    assert np.isfinite(res["mean_auc"]) and torch.isfinite(torch.tensor(trainer.step_losses)).all()


def test_grayscale_statistics_equal_jax(monkeypatch):
    """train_fmnist's pipelines: ``normalize`` after ``grayscale`` takes one
    channel's statistics, as in the JAX package, and the 3-channel CIFAR-100
    OE images come out of the OE pipeline at the normal set's 28x28x1."""
    import torch
    from eoe_tpu.main.train_fmnist import TEST_SPECS, TRAIN_SPECS
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    args = ("fmnist", "", [2], 0, TRAIN_SPECS, TEST_SPECS, None, "cifar100")
    ours = D.load_dataset(*args, rng=np.random.default_rng(1))
    theirs = jax_datasets.load_dataset(*args, rng=np.random.default_rng(1))
    assert len(ours.ds_statistics["mean"]) == 1
    _stats_close(ours.ds_statistics, theirs.ds_statistics)
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(ours.oe.train_set.gather_all()[:4])
    assert ours.oe.train_pipeline(x, generator=g).shape == (4, 28, 28, 1)
    x = torch.from_numpy(ours.test_set.gather_all()[:4])
    assert ours.normal.test_pipeline(x).shape == (4, 28, 28, 1)
