"""Caltech-UCSD Birds 200-2011: the port of eoe_tpu/datasets/cub.py. The
metadata files (images.txt, image_class_labels.txt, train_test_split.txt,
classes.txt) lie under ``<root>/cub/CUB_200_2011/CUB_200_2011/``. No
download."""

import os.path as pt
from typing import List

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, Subset
from eoe_tpu_torch.datasets.folder import FolderSource

_CUB_LABELS_CACHE: List[str] = []


def _meta_dir(root: str) -> str:
    return pt.join(root, "CUB_200_2011", "CUB_200_2011")


def cub_labels(datapath: str = None) -> List[str]:
    """The 200 class names of classes.txt. They are read the first time an
    ADCUB dataset is built, or from ``datapath``; until then the names are
    placeholders (``class_000`` ...). CLIP's prompts need the real names, so
    build the dataset before asking for them."""
    if _CUB_LABELS_CACHE:
        return list(_CUB_LABELS_CACHE)
    if datapath is not None:
        _load_labels(pt.join(datapath, "cub"))
        if _CUB_LABELS_CACHE:
            return list(_CUB_LABELS_CACHE)
    return [f"class_{i:03d}" for i in range(200)]


def _load_labels(ds_root: str):
    global _CUB_LABELS_CACHE
    f = pt.join(_meta_dir(ds_root), "classes.txt")
    if pt.exists(f):
        with open(f) as r:
            _CUB_LABELS_CACHE = [line.split(None, 1)[1].strip().split(".", 1)[-1]
                                 for line in r if line.strip()]


class ADCUB(ADDataset):
    base_folder = "cub"
    degenerate_crop_guard = True

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        _load_labels(ds_root)  # str_labels('cub') returns the real names from now on
        meta = _meta_dir(ds_root)
        if not pt.exists(pt.join(meta, "images.txt")):
            raise FileNotFoundError(
                f"CUB-200-2011 metadata not found at {meta}. Download CUB_200_2011.tgz "
                f"and extract it there (no network egress in this environment).")
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=200,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)

        def read_pairs(name):
            with open(pt.join(meta, name)) as f:
                return dict(line.split(None, 1) for line in f if line.strip())

        rel_paths = {k: v.strip() for k, v in read_pairs("images.txt").items()}
        class_of = {k: int(v) - 1 for k, v in read_pairs("image_class_labels.txt").items()}
        is_train = {k: v.strip() == "1" for k, v in read_pairs("train_test_split.txt").items()}
        ids = sorted(rel_paths, key=int)
        paths = [pt.join(meta, "images", rel_paths[i]) for i in ids]
        targets = np.asarray([class_of[i] for i in ids], np.int64)
        train_mask = np.asarray([is_train[i] for i in ids])

        def build(mask):
            return FolderSource([p for p, m in zip(paths, mask) if m], targets[mask],
                                self.raw_shape, logger)
        self._train_source = build(train_mask)
        self._test_source = build(~train_mask)
        self._train_set = self.create_subset(self._train_source)
        self._test_set = Subset(self._test_source, np.arange(len(self._test_source)))
        self.finalize()
