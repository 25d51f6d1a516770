"""ImageNet-30 as the AD dataset and ImageNet-21k (or its prepared subset) as
OE: the port of eoe_tpu/datasets/imagenet.py.

* ``ADImageNet``: the 30 classes of the one-vs-rest benchmark under
  ``<root>/imagenet_ad/{train,val}``; folder targets are remapped to 0..29
  in ``AD_CLASSES`` order and the other classes dropped (-2, never selected);
  the test split keeps the 30 classes' images only.
* ``ADImageNet21k``: a folder of wnid subdirectories under
  ``<root>/imagenet22k/fall11_whole_extracted``, OE only (no test split),
  without the ImageNet-1k synsets of the 30 classes. From a blob the
  excluded images keep their indices and get target -2; from the folder
  they are left out of the scan. With ``limit_samples`` it decodes into a
  RAM cache of ``img_cache_bytes``.
* ``ADImageNet21kSubSet``: the same over ``<root>/imagenet21k_subset``
  (``build_imagenet21k_subset``).

Each tree is read from its blob (``folder.build_blob``) when one of the raw
shape exists, else decoded by a ``FolderSource``.
"""

import os.path as pt
from typing import List

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, Subset
from eoe_tpu_torch.datasets.folder import (FolderSource, load_blob_source,
                                           scan_image_folder)


def folder_or_blob(folder: str, raw_shape, logger=None, cache_bytes=None):
    """(source, targets, classes) of a class-folder tree: its blob at
    ``raw_shape`` when one exists, else a decoding FolderSource."""
    got = load_blob_source(folder, tuple(raw_shape), logger)
    if got is not None:
        return got
    paths, targets, classes = scan_image_folder(folder)
    kw = {} if cache_bytes is None else {"cache_bytes": cache_bytes}
    return FolderSource(paths, targets, tuple(raw_shape), logger, **kw), targets, classes


AD_CLASSES = ['acorn', 'airliner', 'ambulance', 'american_alligator', 'banjo', 'barn',
              'bikini', 'digital_clock', 'dragonfly', 'dumbbell', 'forklift', 'goblet',
              'grand_piano', 'hotdog', 'hourglass', 'manhole_cover', 'mosque', 'nail',
              'parking_meter', 'pillow', 'revolver', 'rotary_dial_telephone', 'schooner',
              'snowmobile', 'soccer_ball', 'stingray', 'strawberry', 'tank', 'toaster',
              'volcano']

# (class name, ImageNet-1k wnid) of the 30 classes, left out of the 21k OE pool
IMAGENET1K_PAIRS = [
    ('acorn', 'n12267677'), ('airliner', 'n02690373'), ('ambulance', 'n02701002'),
    ('american_alligator', 'n01698640'), ('banjo', 'n02787622'), ('barn', 'n02793495'),
    ('bikini', 'n02837789'), ('digital_clock', 'n03196217'), ('dragonfly', 'n02268443'),
    ('dumbbell', 'n03255030'), ('forklift', 'n03384352'), ('goblet', 'n03443371'),
    ('grand_piano', 'n03452741'), ('hotdog', 'n07697537'), ('hourglass', 'n03544143'),
    ('manhole_cover', 'n03717622'), ('mosque', 'n03788195'), ('nail', 'n03804744'),
    ('parking_meter', 'n03891332'), ('pillow', 'n03938244'), ('revolver', 'n04086273'),
    ('rotary_dial_telephone', 'n03187595'), ('schooner', 'n04147183'),
    ('snowmobile', 'n04252077'), ('soccer_ball', 'n04254680'), ('stingray', 'n01498041'),
    ('strawberry', 'n07745940'), ('tank', 'n04389033'), ('toaster', 'n04442312'),
    ('volcano', 'n09472597'),
]
IMAGENET1K_WNIDS = {wnid for _, wnid in IMAGENET1K_PAIRS}


def _remap_targets(targets: np.ndarray, classes: List[str], keep: List[str]) -> np.ndarray:
    """Folder-class targets -> index in ``keep``, -2 for a dropped class."""
    mapping = np.full(len(classes), -2, dtype=np.int64)
    for new_id, name in enumerate(keep):
        if name in classes:
            mapping[classes.index(name)] = new_id
    return mapping[targets]


class ADImageNet(ADDataset):
    base_folder = "imagenet_ad"
    degenerate_crop_guard = True

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=30,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        tr_src, tr_targets, tr_classes = folder_or_blob(
            pt.join(ds_root, "train"), self.raw_shape, logger)
        te_src, te_targets, te_classes = folder_or_blob(
            pt.join(ds_root, "val"), self.raw_shape, logger)
        tr_targets = _remap_targets(tr_targets, tr_classes, AD_CLASSES)
        te_targets = _remap_targets(te_targets, te_classes, AD_CLASSES)
        tr_src.targets, te_src.targets = tr_targets, te_targets
        self._train_source, self._test_source = tr_src, te_src
        self._train_set = self.create_subset(self._train_source)
        self._test_set = Subset(self._test_source, np.argwhere(te_targets >= 0).flatten())
        self.finalize()


class ADImageNet21k(ADDataset):
    """A folder of wnid subdirectories, used as OE; no test split."""
    base_folder = pt.join("imagenet22k", "fall11_whole_extracted")
    img_cache_bytes = 10 << 30

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        blob = load_blob_source(ds_root, tuple(raw_shape), logger)
        if blob is not None:
            source, targets, classes = blob
            # the 1k synsets get target -2 in place, so blob indices stay stable
            targets = np.where(np.isin(np.asarray(classes)[targets],
                                       list(IMAGENET1K_WNIDS)), -2, targets)
            source.targets = targets
        else:
            paths, targets, classes = scan_image_folder(ds_root)
            keep = ~np.isin(np.asarray([pt.basename(pt.dirname(p)) for p in paths]),
                            list(IMAGENET1K_WNIDS))
            paths = [p for p, k in zip(paths, keep) if k]
            targets = targets[keep]
        n_classes = len(classes)
        super().__init__(
            root=ds_root, normal_classes=list(range(n_classes)) if not normal_classes
            else normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=n_classes,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        cache = self.img_cache_bytes if (isinstance(limit_samples, (list, np.ndarray))
                                         or limit_samples < float("inf")) else 0
        if blob is not None:
            self._train_source = source
        else:
            self._train_source = FolderSource(paths, targets, self.raw_shape, logger,
                                              cache_bytes=cache)
        self._train_set = self.create_subset(self._train_source)
        if cache and blob is None:
            self._train_source.warm_cache(self._train_set.indices[:10000])
        self._test_set = None  # OE only
        self.finalize()


class ADImageNet21kSubSet(ADImageNet21k):
    """The prepared subset folder at ``<root>/imagenet21k_subset``."""
    base_folder = "imagenet21k_subset"


def build_imagenet21k_subset(datapath: str, per_class: int = 50, size: int = 256,
                             seed: int = 0, log=print) -> str:
    """Write the resized 21k subset of ``ADImageNet21kSubSet``: at most
    ``per_class`` images per wnid, drawn from ``seed``, as JPEGs."""
    import os

    from PIL import Image

    from eoe_tpu_torch.datasets.folder import decode_image

    src = pt.join(datapath, "datasets", ADImageNet21k.base_folder)
    dst = pt.join(datapath, "datasets", ADImageNet21kSubSet.base_folder)
    rng = np.random.default_rng(seed)
    classes = sorted(d for d in os.listdir(src) if pt.isdir(pt.join(src, d)))
    if not classes:
        raise FileNotFoundError(f"no class folders under {src}")
    for ci, cls in enumerate(classes):
        files = sorted(os.listdir(pt.join(src, cls)))
        pick = rng.choice(len(files), min(per_class, len(files)), replace=False)
        os.makedirs(pt.join(dst, cls), exist_ok=True)
        for i in sorted(pick):
            try:
                img = decode_image(pt.join(src, cls, files[i]), (size, size))
            except Exception as e:
                log(f"skip {files[i]}: {e}")
                continue
            Image.fromarray(img).save(pt.join(dst, cls, pt.splitext(files[i])[0] + ".jpg"))
        if ci % 100 == 0:
            log(f"{ci}/{len(classes)} classes done")
    log(f"subset complete at {dst}")
    return dst
