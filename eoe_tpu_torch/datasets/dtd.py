"""The Describable Textures Dataset (47 classes): the port of
eoe_tpu/datasets/dtd.py. Layout ``<root>/dtd/dtd/{images/<class>/*.jpg,
labels/{train1,val1,test1}.txt}``: fold 1, train = train1 + val1, test =
test1. Without split files the images folder is scanned and every fifth
image is a test image. No download."""

import os.path as pt

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, Subset
from eoe_tpu_torch.datasets.folder import FolderSource, scan_image_folder

DTD_CLASSES = [
    "banded", "blotchy", "braided", "bubbly", "bumpy", "chequered", "cobwebbed", "cracked",
    "crosshatched", "crystalline", "dotted", "fibrous", "flecked", "freckled", "frilly",
    "gauzy", "grid", "grooved", "honeycombed", "interlaced", "knitted", "lacelike", "lined",
    "marbled", "matted", "meshed", "paisley", "perforated", "pitted", "pleated",
    "polka-dotted", "porous", "potholed", "scaly", "smeared", "spiralled", "sprinkled",
    "stained", "stratified", "striped", "studded", "swirly", "veined", "waffled", "woven",
    "wrinkled", "zigzagged",
]


def _read_split(labels_dir: str, names) -> list:
    rel = []
    for n in names:
        f = pt.join(labels_dir, n)
        if pt.exists(f):
            with open(f) as r:
                rel.extend(line.strip() for line in r if line.strip())
    return rel


class ADDTD(ADDataset):
    base_folder = pt.join("dtd", "dtd")

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=47,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        images = pt.join(ds_root, "images")
        labels = pt.join(ds_root, "labels")
        train_rel = _read_split(labels, ["train1.txt", "val1.txt"])
        test_rel = _read_split(labels, ["test1.txt"])
        if train_rel:
            def build(rel):
                paths = [pt.join(images, r) for r in rel]
                targets = np.asarray([DTD_CLASSES.index(r.split("/")[0]) for r in rel],
                                     np.int64)
                return FolderSource(paths, targets, self.raw_shape, logger)
            self._train_source = build(train_rel)
            self._test_source = build(test_rel)
        else:
            paths, targets, classes = scan_image_folder(images)
            idx = np.arange(len(paths))
            te = idx[idx % 5 == 0]
            tr = idx[idx % 5 != 0]
            self._train_source = FolderSource([paths[i] for i in tr], targets[tr],
                                              self.raw_shape, logger)
            self._test_source = FolderSource([paths[i] for i in te], targets[te],
                                             self.raw_shape, logger)
        self._train_set = self.create_subset(self._train_source)
        self._test_set = Subset(self._test_source, np.arange(len(self._test_source)))
        self.finalize()
