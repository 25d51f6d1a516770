"""The port's folder datasets against the JAX package's, on small synthetic
trees in each dataset's on-disk layout: ImageNet-30 (the 30-class remap),
ImageNet-21k (the ImageNet-1k exclusion, from a folder and from a blob) and
its subset, ImageNet-1k as OE, MVTec-AD (its .npz blob and defect labels),
DTD (split files or none), CUB (metadata, ``cub_labels``) and custom folders
(one-vs-rest or not, as their own OE, sample keys, each layout error).
Subsets, binary targets, sample keys and uint8 gathers must be equal, the
``normalize`` and ``gcn-normalize`` statistics of a folder source equal to
1e-5 relative. Last, a Trainer whose normal half and test split stream from
the host scores as the resident run does, to 1e-5."""

import json
import os
import os.path as pt

import numpy as np
import pytest
from PIL import Image

from eoe_tpu import datasets as JD
from eoe_tpu.datasets import bases as JB
from eoe_tpu.datasets import cub as jax_cub
from eoe_tpu.datasets import custom as jax_custom
from eoe_tpu.datasets import folder as JF
from eoe_tpu_torch import datasets as D
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.datasets import cub as port_cub
from eoe_tpu_torch.datasets import custom as port_custom
from eoe_tpu_torch.datasets import folder as F

SPECS = [{"op": "resize", "size": 16}]


def write_img(path, rng, size=(20, 20)):
    os.makedirs(pt.dirname(str(path)), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8)).save(str(path))


def _parts(ds):
    if isinstance(ds, (B.CombinedDataset, JB.CombinedDataset)):
        return [("normal", ds.normal), ("oe", ds.oe)]
    return [("normal", ds)]


def assert_same(ours, theirs):
    """Every part's subsets: indices, targets, binary targets, sample keys
    and the uint8 images, and the statistics."""
    for (name, o), (_, t) in zip(_parts(ours), _parts(theirs)):
        assert type(o).__name__ == type(t).__name__, name
        assert o.normal_classes == t.normal_classes and o.n_classes == t.n_classes
        for split in ("train_set", "test_set"):
            so, st = getattr(o, split), getattr(t, split)
            if st is None:
                assert so is None, (name, split)
                continue
            np.testing.assert_array_equal(so.indices, st.indices)
            np.testing.assert_array_equal(so.targets, st.targets)
            np.testing.assert_array_equal(o.binary_targets(so), t.binary_targets(st))
            assert so.sample_keys == st.sample_keys
            assert type(so.source).__name__ == type(st.source).__name__
            if len(so):
                np.testing.assert_array_equal(so.gather_all(), st.gather_all())
        assert o.ds_statistics == t.ds_statistics


def both(name, root, normal, **kw):
    """``load_dataset`` of both packages with the same rng seed."""
    args = (name, str(root), normal, 0, kw.pop("train", SPECS), kw.pop("test", SPECS), None)
    return (D.load_dataset(*args, rng=np.random.default_rng(3), **kw),
            JD.load_dataset(*args, rng=np.random.default_rng(3), **kw))


# ----------------------------------------------------------------- imagenet


def imagenet_tree(root, rng):
    from eoe_tpu.datasets.imagenet import AD_CLASSES
    for split, n in (("train", 3), ("val", 2)):
        for cls in ["zz_not_ad"] + AD_CLASSES[:3] + ["bikini"]:
            for i in range(n):
                write_img(root / "imagenet_ad" / split / cls / f"{i}.jpg", rng)
    base = root / "imagenet22k" / "fall11_whole_extracted"
    for wnid in ("n00000001", "n12267677", "n00000003", "n02690373"):  # 2nd, 4th are 1k
        for i in range(3):
            write_img(base / wnid / f"{i}.JPEG", rng)
    for wnid in ("n01", "n02"):
        for i in range(2):
            write_img(root / "imagenet" / "train" / wnid / f"{i}.png", rng)
    for wnid in ("n05", "n06"):
        write_img(root / "imagenet21k_subset" / wnid / "0.jpg", rng)
    return root


@pytest.mark.parametrize("blob", [False, True])
def test_imagenet30_with_21k_oe_equals_jax(tmp_path, rng, blob):
    """The 30-class remap (a class outside the 30 dropped, 'bikini' is class
    6 whatever its folder position), the 1k synsets left out of the 21k OE
    pool (a blob keeps their indices with target -2), an OE size limit."""
    root = imagenet_tree(tmp_path, rng)
    if blob:
        for folder in ("imagenet_ad/train", "imagenet_ad/val",
                       "imagenet22k/fall11_whole_extracted"):
            JF.build_blob(str(root / folder), (16, 16))
    for normal, limit in (([0], float("inf")), ([6], 5), ([1, 2], float("inf"))):
        ours, theirs = both("imagenet", root, normal, oe_name="imagenet21k",
                            oe_limit_samples=limit)
        assert_same(ours, theirs)
        src = ours.oe.train_set.source
        assert isinstance(src, F.BlobSource if blob else F.FolderSource)
        assert len(ours.test_set) == 8 and set(ours.test_set.targets) == {0, 1, 2, 6}
        assert len(ours.oe.train_set) == (6 if limit == float("inf") else 5)
        if blob:   # the excluded synsets' images keep their place in the blob
            assert len(src) == 12 and (src.targets == -2).sum() == 6
            kept = {src.paths[i].split("/")[0] for i in ours.oe.train_set.indices}
            assert kept == {"n00000001", "n00000003"}
        else:
            assert len(src) == 6


def test_imagenet21k_cache_subset_and_oe_only(tmp_path, rng):
    """21k with a sample limit decodes into its RAM cache (warm_cache); the
    subset folder; ImageNet-1k as OE, and refused as the normal set."""
    root = imagenet_tree(tmp_path, rng)
    from eoe_tpu.datasets.imagenet import ADImageNet21k as JaxIN21k
    from eoe_tpu_torch.datasets.imagenet import ADImageNet21k
    args = (str(root), [], 1, SPECS, [], (16, 16, 3))
    ours = ADImageNet21k(*args, limit_samples=4, rng=np.random.default_rng(0))
    theirs = JaxIN21k(*args, limit_samples=4, rng=np.random.default_rng(0))
    assert_same(ours, theirs)
    assert sorted(ours.train_set.source._cache) == sorted(ours.train_set.indices.tolist())
    assert ours.train_set.source.cache_bytes == ADImageNet21k.img_cache_bytes
    for oe in ("imagenet21ksubset", "imagenetoe"):
        assert_same(*both("imagenet", root, [3], oe_name=oe, oe_limit_classes=1))
    with pytest.raises(ValueError, match="only be used as OE"):
        D.load_dataset("imagenetoe", str(root), [0], 0, [], [])


def test_build_imagenet21k_subset_equals_jax(tmp_path, rng):
    from eoe_tpu.datasets.imagenet import build_imagenet21k_subset as jax_build
    from eoe_tpu_torch.datasets.imagenet import build_imagenet21k_subset
    src = tmp_path / "datasets" / "imagenet22k" / "fall11_whole_extracted"
    for wnid in ("n1", "n2"):
        for i in range(4):
            write_img(src / wnid / f"{i}.png", rng, (30, 26))
    out = build_imagenet21k_subset(str(tmp_path), per_class=2, size=16, log=lambda m: None)

    def files(folder):
        return sorted(pt.join(w, f) for w in os.listdir(folder)
                      for f in os.listdir(pt.join(folder, w)))

    ours = {p: np.asarray(Image.open(pt.join(out, p))) for p in files(out)}
    theirs_root = tmp_path / "jax" / "datasets"
    os.makedirs(theirs_root)
    os.rename(str(src.parent), str(theirs_root / "imagenet22k"))
    jout = jax_build(str(theirs_root.parent), per_class=2, size=16, log=lambda m: None)
    assert sorted(ours) == files(jout) and len(ours) == 4
    for p, arr in ours.items():
        np.testing.assert_array_equal(arr, np.asarray(Image.open(pt.join(jout, p))))
        assert arr.shape == (16, 16, 3)


# ----------------------------------------------------------------- mvtec


def mvtec_tree(root, rng):
    for cls in ("cable", "bottle", "zz_unknown"):
        for i in range(3):
            write_img(root / "mvtec" / cls / "train" / "good" / f"{i}.png", rng)
        for defect, n in (("good", 2), ("broken", 2), ("cut", 1)):
            for i in range(n):
                write_img(root / "mvtec" / cls / "test" / defect / f"{i}.png", rng)
    return root


def test_mvtec_blob_and_defect_labels_equal_jax(tmp_path, rng):
    """The port's .npz blob holds the JAX package's arrays; train is the
    'good' images enlarged 10x by index; test labels follow the defect
    folder, not the class."""
    root = mvtec_tree(tmp_path, rng)
    from eoe_tpu.datasets.mvtec import build_blob as jax_build
    from eoe_tpu_torch.datasets.mvtec import build_blob
    path = build_blob(str(root / "mvtec"), (16, 16))
    ours_npz = dict(np.load(path))
    os.remove(path)
    theirs_npz = dict(np.load(jax_build(str(root / "mvtec"), (16, 16))))
    assert sorted(ours_npz) == sorted(theirs_npz)
    for k in ours_npz:
        np.testing.assert_array_equal(ours_npz[k], theirs_npz[k])
    assert list(ours_npz["anomaly_label_strings"]) == [
        "good", "bottle_broken", "bottle_cut", "cable_broken", "cable_cut"]
    for normal in ([0], [1], [0, 1]):
        ours, theirs = both("mvtec", root, normal, oe_name="mvtec")
        assert_same(ours, theirs)
        assert len(ours.train_set) == 30 * len(normal)
        assert sorted(ours.normal.binary_targets(ours.test_set).tolist()) == \
            sorted([0, 0, 1, 1, 1] * len(normal))
        assert ours.normal.anomaly_label_strings == theirs.normal.anomaly_label_strings
    os.remove(path)
    os.makedirs(tmp_path / "none" / "mvtec" / "not_a_class")
    with pytest.raises(FileNotFoundError, match="No MVTec-AD data"):
        D.load_dataset("mvtec", str(tmp_path / "none"), [0], 0, SPECS, SPECS)


# ----------------------------------------------------------------- dtd / cub


@pytest.mark.parametrize("split_files", [True, False])
def test_dtd_equals_jax(tmp_path, rng, split_files):
    from eoe_tpu_torch.datasets.dtd import DTD_CLASSES
    base = tmp_path / "dtd" / "dtd"
    rel = []
    for cls in DTD_CLASSES[:3]:
        for i in range(5):
            rel.append(f"{cls}/{cls}_{i}.jpg")
            write_img(base / "images" / rel[-1], rng)
    if split_files:
        os.makedirs(base / "labels")
        (base / "labels" / "train1.txt").write_text("\n".join(rel[0::5] + rel[1::5]) + "\n\n")
        (base / "labels" / "val1.txt").write_text("\n".join(rel[2::5]))
        (base / "labels" / "test1.txt").write_text("\n".join(rel[3::5] + rel[4::5]))
    for normal in ([0], [2]):
        ours, theirs = both("dtd", tmp_path, normal)
        assert_same(ours, theirs)
        assert len(ours.train_set) == (3 if split_files else 4)
        assert len(ours.test_set) == (6 if split_files else 3)


def cub_tree(root, rng):
    meta = root / "cub" / "CUB_200_2011" / "CUB_200_2011"
    os.makedirs(meta)
    lines_i, lines_c, lines_s, lines_cls = [], [], [], []
    for ci in range(3):
        lines_cls.append(f"{ci + 1} {ci + 1:03d}.Bird_Number_{ci}")
        for i in range(3):
            img_id = ci * 3 + i + 1
            r = f"{ci + 1:03d}.Bird_Number_{ci}/img_{i}.jpg"
            write_img(meta / "images" / r, rng)
            lines_i.append(f"{img_id} {r}")
            lines_c.append(f"{img_id} {ci + 1}")
            lines_s.append(f"{img_id} {1 if i < 2 else 0}")
    order = [4, 0, 8, 2, 6, 1, 5, 3, 7]   # the files need not list ids in order
    (meta / "images.txt").write_text("\n".join(lines_i[j] for j in order))
    (meta / "image_class_labels.txt").write_text("\n".join(lines_c))
    (meta / "train_test_split.txt").write_text("\n".join(lines_s))
    (meta / "classes.txt").write_text("\n".join(lines_cls))
    return root


def test_cub_metadata_and_labels_equal_jax(tmp_path, rng, monkeypatch):
    """Split and classes from the metadata; ``cub_labels`` gives placeholders
    until a CUB dataset is built (or a datapath is given), then the names."""
    monkeypatch.setattr(port_cub, "_CUB_LABELS_CACHE", [])
    monkeypatch.setattr(jax_cub, "_CUB_LABELS_CACHE", [])
    assert D.str_labels("cub") == JD.str_labels("cub") == [f"class_{i:03d}" for i in range(200)]
    root = cub_tree(tmp_path, rng)
    assert port_cub.cub_labels(str(root))[:3] == ["Bird_Number_0", "Bird_Number_1",
                                                  "Bird_Number_2"]
    monkeypatch.setattr(port_cub, "_CUB_LABELS_CACHE", [])
    for normal in ([1], [0, 2]):
        ours, theirs = both("cub", root, normal)
        assert_same(ours, theirs)
        assert len(ours.train_set) == 2 * len(normal) and len(ours.test_set) == 3
    assert D.str_labels("cub") == JD.str_labels("cub") == ["Bird_Number_0", "Bird_Number_1",
                                                           "Bird_Number_2"]
    assert D.no_classes("cub") == JD.no_classes("cub") == 200
    with pytest.raises(FileNotFoundError, match="CUB-200-2011 metadata not found"):
        D.load_dataset("cub", str(tmp_path / "none"), [0], 0, SPECS, SPECS)


# ----------------------------------------------------------------- custom


@pytest.fixture
def custom_state(monkeypatch):
    """The custom dataset's class attributes, restored after the test."""
    for mod in (port_custom, jax_custom):
        for attr, value in (("classes", []), ("ovr", False), ("train_only", False),
                            ("eval_only", False), ("base_folder", "custom")):
            monkeypatch.setattr(mod.ADCustomDS, attr, value)
    for mod in (D, JD):
        monkeypatch.setitem(mod.DS_CHOICES, "custom", dict(mod.DS_CHOICES["custom"]))


def custom_tree(root, rng, ovr=False):
    for split in ("train", "test"):
        for cls in ("screw", "hazelnut"):
            if ovr:
                for i in range(3):
                    write_img(root / "custom" / split / cls / f"{i}.png", rng)
                continue
            for i in range(3):
                write_img(root / "custom" / split / cls / "normal" / f"{i}.png", rng)
            for i in range(2):
                write_img(root / "custom" / split / cls / "Anomalous" / f"a{i}.jpg", rng)
    return root


def _set(attr, value):
    for mod in (port_custom, jax_custom):
        setattr(mod.ADCustomDS, attr, value)


@pytest.mark.parametrize("ovr", [False, True])
def test_custom_equals_jax(tmp_path, rng, custom_state, ovr):
    """Classes from the folders; anomaly labels from the folder names (or
    the class, one-vs-rest); the test split's sample keys; the custom set as
    its own OE (its anomalous folders), refused with an OE class limit and
    in the one-vs-rest mode."""
    root = custom_tree(tmp_path, rng, ovr)
    _set("ovr", ovr)
    assert port_custom.ADCustomDS.determine_classes(str(root)) == \
        jax_custom.ADCustomDS.determine_classes(str(root)) == ["hazelnut", "screw"]
    for normal in ([0], [1]):
        ours, theirs = both("custom", root, normal)
        assert_same(ours, theirs)
        keys = ours.test_set.sample_keys
        assert len(keys) == (6 if ovr else 5) and all(not pt.isabs(k) for k in keys)
        assert sorted(ours.binary_targets(ours.test_set).tolist()) == \
            ([0] * 3 + [1] * 3 if ovr else [0] * 3 + [1] * 2)
        if ovr:
            with pytest.raises(ValueError, match="mutually exclusive with custom OE"):
                D.load_dataset("custom", str(root), normal, 0, SPECS, SPECS, oe_name="custom")
            continue
        ours, theirs = both("custom", root, normal, oe_name="custom")
        assert_same(ours, theirs)
        assert len(ours.oe.train_set) == 2
        assert set(ours.oe.binary_targets(ours.oe.train_set).tolist()) == {1}
        with pytest.raises(ValueError, match="limiting the OE classes"):
            D.load_dataset("custom", str(root), normal, 0, SPECS, SPECS, oe_name="custom",
                           oe_limit_classes=1)


def test_custom_split_less_layouts_equal_jax(tmp_path, rng, custom_state):
    """Training-only and inference-only folders directly in the root; the
    unlabeled images are -1."""
    for d in ("normal", "anomalous", "unlabeled"):
        for i in range(2):
            write_img(tmp_path / d / f"{i}.png", rng)
    _set("base_folder", ".")
    for attr in ("eval_only", "train_only"):
        _set(attr, True)
        _set("classes", [])
        args = (str(tmp_path), [0], 0, SPECS, SPECS, (16, 16, 3))
        ours = port_custom.ADCustomDS(*args, rng=np.random.default_rng(0))
        theirs = jax_custom.ADCustomDS(*args, rng=np.random.default_rng(0))
        assert_same(ours, theirs)
        if attr == "eval_only":
            assert ours.train_set is None
            assert sorted(ours.binary_targets(ours.test_set).tolist()) == [-1, -1, 0, 0, 1, 1]
        else:
            assert ours.test_set is None and len(ours.train_set) == 2
        _set(attr, False)


LAYOUT_ERRORS = {
    "no_train": lambda r: None,
    "reserved_class": lambda r: [os.makedirs(r / "custom" / s / "normal")
                                 for s in ("train", "test")],
    "no_normal": lambda r: [os.makedirs(r / "custom" / s / "cat" / "anomalous")
                            for s in ("train", "test")],
    "bad_subfolder": lambda r: [os.makedirs(r / "custom" / s / "cat" / d)
                                for s in ("train", "test") for d in ("normal", "weird")],
    "class_mismatch": lambda r: [os.makedirs(r / "custom" / s / c / "normal")
                                 for s, c in (("train", "cat"), ("test", "dog"))],
    "no_test": lambda r: os.makedirs(r / "custom" / "train" / "cat" / "normal"),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_ERRORS))
def test_custom_layout_errors_equal_jax(tmp_path, case, custom_state):
    """Each invalid layout raises the JAX package's exception type and
    message, from the dataset and from ``check_custom_layout``."""
    LAYOUT_ERRORS[case](tmp_path)

    def error(fn):
        try:
            fn()
        except Exception as e:  # the type is part of the comparison
            return type(e), str(e)
        return None

    def build(mod):
        mod.ADCustomDS.classes = ["cat"]
        mod.ADCustomDS(str(tmp_path), [0], 0, [], [], (8, 8, 3))

    got, want = error(lambda: build(port_custom)), error(lambda: build(jax_custom))
    assert got == want and got is not None and got[0] is ValueError, (got, want)
    for ovr, train_only, eval_only in ((False, False, False), (True, False, False),
                                       (True, True, False), (False, True, False),
                                       (False, False, True)):
        for root in (str(tmp_path / "custom"), str(tmp_path)):
            assert error(lambda: port_custom.check_custom_layout(
                root, ovr, train_only, eval_only)) == error(
                lambda: jax_custom.check_custom_layout(root, ovr, train_only, eval_only))


# ----------------------------------------------------------------- statistics


@pytest.mark.parametrize("norm", ["normalize", "gcn-normalize"])
def test_folder_statistics_equal_jax(tmp_path, rng, norm):
    """The statistics of a decoding FolderSource (DTD without split files)
    match the JAX package's to 1e-5 relative, and both write the same cache."""
    from eoe_tpu_torch.datasets.dtd import DTD_CLASSES
    for cls in DTD_CLASSES[:2]:
        for i in range(6):
            write_img(tmp_path / "dtd" / "dtd" / "images" / cls / f"{i}.png", rng, (24, 18))
    specs = SPECS + [norm]
    ours = D.load_dataset("dtd", str(tmp_path), [1], 0, specs, specs)
    os.remove(tmp_path / "dtd" / "dtd" / "stats_cache.json")
    theirs = JD.load_dataset("dtd", str(tmp_path), [1], 0, specs, specs)
    mean, std = ours.ds_statistics["mean"], ours.ds_statistics["std"]
    np.testing.assert_allclose(mean, theirs.ds_statistics["mean"], rtol=1e-5)
    np.testing.assert_allclose(std, theirs.ds_statistics["std"], rtol=1e-5)
    assert isinstance(ours.train_set.source, F.FolderSource) and len(mean) == 3


# ----------------------------------------------------------------- streaming


def _run(tmp_path, cache_mb, objective, monkeypatch):
    """Trainer.run by name on the ImageNet-30 tree (21k as OE): CNN32 at
    32x32, fixed seeds; returns the trainer and its test scores."""
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.utils.logger import Logger
    monkeypatch.setattr(F.FolderSource, "DEFAULT_CACHE_BYTES", cache_mb << 20)
    specs = [{"op": "resize", "size": 32}, {"op": "random_hflip", "p": 0.5}]
    trainer = TRAINER[objective](
        model=CNN32(rep_dim=16), train_specs=specs, test_specs=specs[:1], dataset="imagenet",
        oe_dataset="imagenet21k", datapath=str(tmp_path),
        logger=Logger(str(tmp_path / f"log{cache_mb}"), "run"), epochs=2, lr=1e-3, wdk=0.0,
        milestones=[1], batch_size=4, device="cpu")
    streamed = []
    for name in ("gather", "gather_all"):
        orig = getattr(B.Subset, name)
        monkeypatch.setattr(B.Subset, name, lambda self, *a, _o=orig, _n=name:
                            streamed.append((_n, len(self.source), len(a[0]) if a else
                                             len(self))) or _o(self, *a))
    _, res = trainer.run(run_classes=[1], run_seeds=1)
    monkeypatch.undo()
    with open(pt.join(trainer.logger.dir, "eval_cls1_it0_anomaly_scores.json")) as f:
        scores = json.load(f)
    return res, np.asarray([scores[k] for k in sorted(scores, key=int)]), streamed


@pytest.mark.parametrize("objective", ["hsc", "dsvdd"])
def test_streamed_split_scores_equal_resident(tmp_path, rng, objective, monkeypatch):
    """With the folder cache at 0 the normal half, the test split (and
    DSVDD's centre) stream from the host batch by batch; the scores equal
    the resident run's with the same draws to 1e-5."""
    imagenet_tree(tmp_path, rng)
    res_r, scores_r, calls_r = _run(tmp_path, 2048, objective, monkeypatch)
    res_s, scores_s, calls_s = _run(tmp_path, 0, objective, monkeypatch)
    n_train, n_test = 15, 10   # the ImageNet-30 train and val folders' images
    # resident: each split gathered whole; streaming: batches of at most 4,
    # after the eval preview's one gather per binary class of the test split
    assert ("gather_all", n_train, 3) in calls_r and ("gather_all", n_test, 8) in calls_r
    assert not any(n == "gather_all" and src in (n_train, n_test) for n, src, _ in calls_s)
    test_gathers = [k for n, src, k in calls_s if src == n_test]
    assert len(test_gathers) == 4 and sum(test_gathers[:2]) == 8 and test_gathers[2:] == [4, 4]
    assert max(k for n, src, k in calls_s if src == n_train) == 4
    assert np.isfinite(scores_r).all() and len(scores_r) == 8
    np.testing.assert_allclose(scores_s, scores_r, rtol=1e-5, atol=1e-7)
    assert res_s["mean_auc"] == pytest.approx(res_r["mean_auc"], abs=1e-6)
