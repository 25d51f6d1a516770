"""MVTec-AD: 15 object and texture classes with per-class defect folders.
The port of eoe_tpu/datasets/mvtec.py.

* The raw tree ``<root>/mvtec/<class>/{train,test}/<defect>/*`` is decoded
  once into the resized blob ``admvtec_{h}x{w}.npz`` beside it; later runs
  read the blob, whose splits are resident arrays.
* The train split holds the 'good' images only and is enlarged 10x by
  repeating its subset's indices (not its data).
* Test labels come from the defect folder ('good' -> nominal, any defect ->
  anomalous), not from the object class; the test split keeps the normal
  classes' images.
* There is no download: place the extracted archive under ``<root>/mvtec``.
"""

import os
import os.path as pt
from typing import List, Tuple

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, ArraySource, Subset
from eoe_tpu_torch.datasets.folder import decode_image

LABELS = ('bottle', 'cable', 'capsule', 'carpet', 'grid', 'hazelnut', 'leather',
          'metal_nut', 'pill', 'screw', 'tile', 'toothbrush', 'transistor',
          'wood', 'zipper')
NORMAL_DEFECT = "good"
NORMAL_DEFECT_IDX = 0
ENLARGE = 10


def _blob_path(root: str, hw: Tuple[int, int]) -> str:
    return pt.join(root, f"admvtec_{hw[0]}x{hw[1]}.npz")


def build_blob(root: str, hw: Tuple[int, int], logger=None) -> str:
    """Decode and resize the raw tree into the ``.npz`` blob: train images and
    classes, test images, classes and defect labels, and the defect names."""
    classes = [d for d in sorted(os.listdir(root)) if pt.isdir(pt.join(root, d))]
    classes = [c for c in classes if c in LABELS]
    if not classes:
        raise FileNotFoundError(
            f"No MVTec-AD data found under {root}. Download mvtec_anomaly_detection.tar.xz "
            f"from https://www.mvtec.com/company/research/datasets/mvtec-ad and extract it "
            f"there (no network egress in this environment).")
    anomaly_label_strings: List[str] = [NORMAL_DEFECT]
    tr_imgs, tr_lbls, te_imgs, te_lbls, te_anom = [], [], [], [], []
    for cls in classes:
        ci = LABELS.index(cls)
        tdir = pt.join(root, cls, "train", NORMAL_DEFECT)
        for fn in sorted(os.listdir(tdir)):
            if fn.lower().endswith((".png", ".jpg")):
                tr_imgs.append(decode_image(pt.join(tdir, fn), hw))
                tr_lbls.append(ci)
        edir = pt.join(root, cls, "test")
        for defect in sorted(os.listdir(edir)):
            ddir = pt.join(edir, defect)
            if not pt.isdir(ddir):
                continue
            if defect == NORMAL_DEFECT:
                didx = NORMAL_DEFECT_IDX
            else:
                name = f"{cls}_{defect}"
                if name not in anomaly_label_strings:
                    anomaly_label_strings.append(name)
                didx = anomaly_label_strings.index(name)
            for fn in sorted(os.listdir(ddir)):
                if fn.lower().endswith((".png", ".jpg")):
                    te_imgs.append(decode_image(pt.join(ddir, fn), hw))
                    te_lbls.append(ci)
                    te_anom.append(didx)
    path = _blob_path(root, hw)
    np.savez_compressed(
        path, train_data=np.stack(tr_imgs), train_labels=np.asarray(tr_lbls, np.int64),
        test_data=np.stack(te_imgs), test_labels=np.asarray(te_lbls, np.int64),
        test_anomaly_labels=np.asarray(te_anom, np.int64),
        anomaly_label_strings=np.asarray(anomaly_label_strings))
    if logger is not None:
        logger.print(f"preprocessed MVTec-AD into {path}")
    return path


class ADMvTec(ADDataset):
    base_folder = "mvtec"

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=15,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        hw = self.raw_shape[:2]
        blob = _blob_path(ds_root, hw)
        if not pt.exists(blob):
            blob = build_blob(ds_root, hw, logger)
        d = np.load(blob, allow_pickle=False)
        self.anomaly_label_strings = [str(s) for s in d["anomaly_label_strings"]]

        self._train_source = ArraySource(d["train_data"], d["train_labels"])
        base_subset = self.create_subset(self._train_source)
        self._train_set = Subset(self._train_source, np.tile(base_subset.indices, ENLARGE))

        self._test_source = ArraySource(d["test_data"], d["test_labels"])
        self.test_anomaly_labels = d["test_anomaly_labels"]
        keep = np.argwhere(np.isin(d["test_labels"], self.normal_classes)).flatten()
        self._test_set = Subset(self._test_source, keep)
        self.finalize()

    def binary_targets(self, subset: Subset) -> np.ndarray:
        """Test labels follow the defect annotation, not the object class."""
        if subset is self._test_set or (subset is not None and
                                        subset.source is self._test_source):
            anom = self.test_anomaly_labels[subset.indices]
            return np.where(anom == NORMAL_DEFECT_IDX, self.nominal_label,
                            self.anomalous_label).astype(np.int64)
        return super().binary_targets(subset)
