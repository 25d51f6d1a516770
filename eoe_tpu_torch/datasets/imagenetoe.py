"""ImageNet-1k as an OE set only (the registry's ``oe_only``): the port of
eoe_tpu/datasets/imagenetoe.py. Layout ``<root>/imagenet/train/<wnid>/*``;
no test split."""

import os.path as pt

from eoe_tpu_torch.datasets.bases import ADDataset
from eoe_tpu_torch.datasets.folder import FolderSource, scan_image_folder


class ADImageNetOE(ADDataset):
    base_folder = "imagenet"
    degenerate_crop_guard = True

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        paths, targets, classes = scan_image_folder(pt.join(ds_root, "train"))
        super().__init__(
            root=ds_root, normal_classes=normal_classes or list(range(len(classes))),
            nominal_label=nominal_label, train_specs=train_specs, test_specs=test_specs,
            n_classes=len(classes), raw_shape=raw_shape, logger=logger,
            limit_samples=limit_samples, train_conditional=train_conditional,
            test_conditional=test_conditional, ds_statistics=ds_statistics, rng=rng)
        self._train_source = FolderSource(paths, targets, self.raw_shape, logger)
        self._train_set = self.create_subset(self._train_source)
        self._test_set = None  # OE only
        self.finalize()
