"""Custom image-folder AD datasets with layout validation: the port of
eoe_tpu/datasets/custom.py.

* Combined layouts under ``<root>/custom/{train,test}/``: one-vs-rest class
  folders (``train/dog/*.png``, ``ADCustomDS.ovr``) or the general layout
  with ``normal``/``anomalous`` subfolders per class.
* Split-less layouts directly in the root, ``normal``/``anomalous``/
  ``unlabeled`` folders, for training only or inference only (the class
  attributes ``train_only``/``eval_only``).
* Sample-wise anomaly labels from the folder names; ``unlabeled`` is -1
  (``UNLABLED_LBL``), which the trainer leaves out of its metrics.
* As its own OE set (``oe=True``) the dataset takes the anomalous folders of
  the normal classes.
* Scores are keyed by each file's path relative to its split folder
  (``sample_keys``).
"""

import os
import os.path as pt
from typing import List

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, Subset
from eoe_tpu_torch.datasets.folder import IMG_EXTENSIONS, FolderSource

UNLABLED_LBL = -1

NORMAL_DIRS = ("normal", "nominal")
ANOMALY_DIRS = ("anomalous", "anomaly", "anomalies", "oe", "outlier-exposure")
UNLABELED_DIRS = ("unlabeled",)


def check_custom_layout(root: str, ovr: bool, train_only: bool = False,
                        eval_only: bool = False):
    """Validate a custom dataset tree. ``root`` is the folder holding
    train/test (combined layouts) or the split-less normal/anomalous folders
    (train_only / eval_only). Raises ValueError on any deviation."""
    combined = not (train_only or eval_only)
    trainpath = pt.join(root, "train") if combined else root
    testpath = pt.join(root, "test") if combined else root
    if not eval_only and not pt.exists(trainpath):
        raise ValueError(f"No custom data found since {trainpath} does not exist.")
    if not train_only and not pt.exists(testpath):
        raise ValueError(f"No custom data found since {testpath} does not exist.")
    if combined:
        reserved = ("normal", "nominal", "anomalous")
        if any(d.lower() in reserved for d in os.listdir(trainpath)):
            raise ValueError(
                f'Found a class folder named "normal", "nominal", or "anomalous" in '
                f'({trainpath}). Class folders need to match class names (like "dog", '
                f'"hazelnut"); in the general mode place samples in CLASS_NAME/normal '
                f'and CLASS_NAME/anomalous.')
        if not ovr:
            valid = NORMAL_DIRS + ANOMALY_DIRS
            for split_dir in (trainpath, testpath):
                for cls_dir in os.listdir(split_dir):
                    sub = [d.lower() for d in os.listdir(pt.join(split_dir, cls_dir))]
                    if "normal" not in sub:
                        raise ValueError(
                            f'All class folders need a "normal" subfolder; none found '
                            f"in {pt.join(split_dir, cls_dir)}.")
                    for lbl_dir in sub:
                        if lbl_dir not in valid:
                            raise ValueError(
                                f'Class folders may only contain {valid}; found '
                                f'"{lbl_dir}" in {pt.join(split_dir, cls_dir)}.')
        train_classes = sorted(os.listdir(trainpath))
        test_classes = sorted(os.listdir(testpath))
        if train_classes != test_classes:
            raise ValueError(
                f"The training class names and test class names do not match: "
                f"{train_classes} vs {test_classes}.")
    else:
        if ovr:
            raise ValueError(
                "One-vs-rest evaluation mode not supported for separate training "
                "and inference.")
        dirs = [d.lower() for d in os.listdir(root) if pt.isdir(pt.join(root, d))]
        if train_only and "normal" not in dirs:
            raise ValueError(
                f'The dataset folder at {root} needs a "normal" folder for '
                f"normal training samples.")
        if eval_only and not (set(dirs) & set(NORMAL_DIRS + ANOMALY_DIRS + UNLABELED_DIRS)):
            raise ValueError(
                f"The dataset folder at {root} needs at least one of: "
                f'"normal", "anomalous", "unlabeled".')
        valid = NORMAL_DIRS + ANOMALY_DIRS + UNLABELED_DIRS
        for d in dirs:
            if d not in valid:
                raise ValueError(
                    f'The dataset folder at {root} contains "{d}"; valid folder '
                    f"names are {valid}.")


def _is_img(fn: str) -> bool:
    return fn.lower().endswith(IMG_EXTENSIONS)


class ADCustomDS(ADDataset):
    base_folder = "custom"
    degenerate_crop_guard = True
    ovr = False
    classes: List[str] = []
    train_only = False
    eval_only = False

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None,
                 oe: bool = False):
        ds_root = pt.join(root, self.base_folder)
        if not type(self).classes:
            type(self).classes = self.determine_classes(root)
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=len(type(self).classes),
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        self.check_data()
        if self.ovr and oe:
            raise ValueError(
                "Custom datasets in the one-vs-rest mode are mutually exclusive with custom OE.")
        self.oe = oe

        if self.eval_only:
            self._train_set = None
            self._train_source = None
        else:
            split_dir = pt.join(ds_root, "train") if not self.train_only else ds_root
            self._train_source = self._scan(split_dir, splitless=self.train_only)
            self._train_set = self._make_subset(self._train_source, oe=oe)

        if self.train_only:
            self._test_set = None
            self._test_source = None
        else:
            split_dir = pt.join(ds_root, "test") if not self.eval_only else ds_root
            self._test_source = self._scan(split_dir, splitless=self.eval_only)
            if self.ovr:
                idcs = np.arange(len(self._test_source))
            else:
                idcs = np.argwhere(np.isin(self._test_source.targets,
                                           self.normal_classes)).flatten()
            self._test_set = Subset(self._test_source, idcs)
        self.finalize()

    # ------------------------------------------------------------- scanning

    def _scan(self, split_dir: str, splitless: bool) -> FolderSource:
        """Build a FolderSource with class targets + per-sample anomaly labels
        and relative-path sample keys."""
        paths, targets, anomaly = [], [], []
        if splitless:
            for lbl_dir in sorted(os.listdir(split_dir)):
                full = pt.join(split_dir, lbl_dir)
                if not pt.isdir(full):
                    continue
                low = lbl_dir.lower()
                a = (self.nominal_label if low in NORMAL_DIRS
                     else (1 - self.nominal_label) if low in ANOMALY_DIRS
                     else UNLABLED_LBL)
                for fn in sorted(os.listdir(full)):
                    if _is_img(fn):
                        paths.append(pt.join(full, fn))
                        targets.append(0)
                        anomaly.append(a)
        elif self.ovr:
            for ci, cls in enumerate(type(self).classes):
                cdir = pt.join(split_dir, cls)
                for dirpath, _, fns in sorted(os.walk(cdir)):
                    for fn in sorted(fns):
                        if _is_img(fn):
                            paths.append(pt.join(dirpath, fn))
                            targets.append(ci)
                            # one-vs-rest anomaly labels follow the class
                            anomaly.append(self.nominal_label if ci in self.normal_classes
                                           else 1 - self.nominal_label)
        else:
            for ci, cls in enumerate(type(self).classes):
                cdir = pt.join(split_dir, cls)
                for lbl_dir in sorted(os.listdir(cdir)):
                    full = pt.join(cdir, lbl_dir)
                    if not pt.isdir(full):
                        continue
                    low = lbl_dir.lower()
                    a = (self.nominal_label if low in NORMAL_DIRS
                         else (1 - self.nominal_label) if low in ANOMALY_DIRS
                         else UNLABLED_LBL)
                    for fn in sorted(os.listdir(full)):
                        if _is_img(fn):
                            paths.append(pt.join(full, fn))
                            targets.append(ci)
                            anomaly.append(a)
        keys = [pt.relpath(p, split_dir) for p in paths]
        src = FolderSource(paths, np.asarray(targets, np.int64), self.raw_shape,
                           self.logger, sample_keys=keys)
        src.anomaly_labels = np.asarray(anomaly, np.int64)
        return src

    def _make_subset(self, source: FolderSource, oe: bool) -> Subset:
        """Normal-class and anomaly-label filter, then limit_samples."""
        want = self.nominal_label if not oe else 1 - self.nominal_label
        idcs = np.argwhere(np.isin(source.targets, self.normal_classes)
                           & (source.anomaly_labels == want)).flatten()
        if isinstance(self.limit_samples, (int, float)) and self.limit_samples < float("inf"):
            k = min(int(self.limit_samples), len(idcs))
            idcs = np.sort(self.rng.choice(idcs, k, replace=False))
        elif not isinstance(self.limit_samples, (int, float)):
            idcs = np.asarray(self.limit_samples, dtype=np.int64)
        return Subset(source, idcs)

    # ------------------------------------------------------------- labels

    def binary_targets(self, subset: Subset) -> np.ndarray:
        """Anomaly labels come from the folder structure (general mode) or
        the class membership (ovr)."""
        anomaly = getattr(subset.source, "anomaly_labels", None)
        if anomaly is not None and not self.ovr:
            return anomaly[subset.indices]
        return super().binary_targets(subset)

    # ------------------------------------------------------------- discovery

    @staticmethod
    def determine_classes(root: str) -> List[str]:
        """The class folders under ``root``/custom/train."""
        if ADCustomDS.train_only or ADCustomDS.eval_only:
            ADCustomDS.classes = ["data"]
            return ADCustomDS.classes
        train = pt.join(root, ADCustomDS.base_folder, "train")
        if not pt.isdir(train):
            raise ValueError(f"No custom data found since {train} does not exist.")
        classes = sorted(fd for fd in os.listdir(train) if pt.isdir(pt.join(train, fd)))
        ADCustomDS.classes = classes
        return classes

    # ------------------------------------------------------------- validation

    def check_data(self):
        """Layout validation (``check_custom_layout``)."""
        check_custom_layout(self.root, self.ovr, self.train_only, self.eval_only)
