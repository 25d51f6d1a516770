"""Datasets of the port: the registry and factory of
eoe_tpu/datasets/__init__.py, and in ``bases`` the AD dataset layer over
in-memory sources.

``load_dataset`` builds CIFAR-10, CIFAR-100, MNIST, EMNIST (letters),
Fashion-MNIST (``cifar``, ``mnist``) and 80 Million Tiny Images
(``tinyimages``) by name, with an OE dataset beside the normal one and the
multi-scale modes (``MSM``) as label-conditional pipelines, as the JAX
package does. The other registry entries (ImageNet, the folder datasets,
MVTec, DTD, CUB, custom) are not ported yet and raise. The trainers also
take a pinned dataset (``trainer.ds``).
"""

import importlib
from copy import deepcopy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

CIFAR10_LABELS = [
    "airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse", "ship", "truck",
]

CIFAR100_LABELS = [
    "beaver", "dolphin", "otter", "seal", "whale", "aquarium_fish", "flatfish", "ray",
    "shark", "trout", "orchid", "poppy", "rose", "sunflower", "tulip", "bottle", "bowl",
    "can", "cup", "plate", "apple", "mushroom", "orange", "pear", "sweet_pepper", "clock",
    "keyboard", "lamp", "telephone", "television", "bed", "chair", "couch", "table",
    "wardrobe", "bee", "beetle", "butterfly", "caterpillar", "cockroach", "bear", "leopard",
    "lion", "tiger", "wolf", "bridge", "castle", "house", "road", "skyscraper", "cloud",
    "forest", "mountain", "plain", "sea", "camel", "cattle", "chimpanzee", "elephant",
    "kangaroo", "fox", "porcupine", "possum", "raccoon", "skunk", "crab", "lobster",
    "snail", "spider", "worm", "baby", "boy", "girl", "man", "woman", "crocodile",
    "dinosaur", "lizard", "snake", "turtle", "hamster", "mouse", "rabbit", "shrew",
    "squirrel", "maple_tree", "oak_tree", "palm_tree", "pine_tree", "willow_tree",
    "bicycle", "bus", "motorcycle", "pickup_truck", "train", "lawn_mower", "rocket",
    "streetcar", "tank", "tractor",
]

MNIST_LABELS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
]

FMNIST_LABELS = [
    "top", "trouser", "pullover", "dress", "coat", "sandal", "shirt", "sneaker", "bag",
    "ankle_boot",
]

IMAGENET30_LABELS = [
    "acorn", "airliner", "ambulance", "american_alligator", "banjo", "barn", "bikini",
    "digital_clock", "dragonfly", "dumbbell", "forklift", "goblet", "grand_piano", "hotdog",
    "hourglass", "manhole_cover", "mosque", "nail", "parking_meter", "pillow", "revolver",
    "rotary_dial_telephone", "schooner", "snowmobile", "soccer_ball", "stingray",
    "strawberry", "tank", "toaster", "volcano",
]

MVTEC_LABELS = [
    "bottle", "cable", "capsule", "carpet", "grid", "hazelnut", "leather", "metal_nut",
    "pill", "screw", "tile", "toothbrush", "transistor", "wood", "zipper",
]

DTD_LABELS = [
    "banded", "blotchy", "braided", "bubbly", "bumpy", "chequered", "cobwebbed", "cracked",
    "crosshatched", "crystalline", "dotted", "fibrous", "flecked", "freckled", "frilly",
    "gauzy", "grid", "grooved", "honeycombed", "interlaced", "knitted", "lacelike", "lined",
    "marbled", "matted", "meshed", "paisley", "perforated", "pitted", "pleated",
    "polka-dotted", "porous", "potholed", "scaly", "smeared", "spiralled", "sprinkled",
    "stained", "stratified", "striped", "studded", "swirly", "veined", "waffled", "woven",
    "wrinkled", "zigzagged",
]

STR_LABELS: Dict[str, List[str]] = {
    "cifar10": CIFAR10_LABELS, "cifar100": CIFAR100_LABELS, "mnist": MNIST_LABELS,
    "emnist": [str(i) for i in range(26)], "fmnist": FMNIST_LABELS,
    "imagenet": IMAGENET30_LABELS, "tinyimages": ["tiny_image"], "mvtec": MVTEC_LABELS,
    "dtd": DTD_LABELS,
}


def str_labels(dataset_name: str) -> List[str]:
    if dataset_name not in STR_LABELS:
        raise NotImplementedError(f"the class labels of {dataset_name!r} are not ported yet")
    return STR_LABELS[dataset_name]


def no_classes(dataset_name: str) -> int:
    return len(str_labels(dataset_name))


# string ids of the filter transforms usable in MSMs
MSM_TRANSFORMS = ("blur", "sharpen", "hpf", "lpf")
TRAIN_NOMINAL_ID, TRAIN_OE_ID, TEST_NOMINAL_ID, TEST_ANOMALOUS_ID = 0, 1, 2, 3
DS_PARTS = {
    "train_nominal": TRAIN_NOMINAL_ID, "train_oe": TRAIN_OE_ID,
    "test_nominal": TEST_NOMINAL_ID, "test_anomalous": TEST_ANOMALOUS_ID,
}

_PORTED = {"cifar10": ("cifar", "ADCIFAR10"), "cifar100": ("cifar", "ADCIFAR100"),
           "mnist": ("mnist", "ADMNIST"), "emnist": ("mnist", "ADEMNIST"),
           "fmnist": ("mnist", "ADFMNIST"), "tinyimages": ("tinyimages", "ADTinyImages")}

# the JAX package's registry: raw size, class count, OE-only; ``module`` and
# ``cls`` are None where the dataset is not ported yet
DS_CHOICES: Dict[str, dict] = {
    name: dict(module=f"eoe_tpu_torch.datasets.{_PORTED[name][0]}" if name in _PORTED else None,
               cls=_PORTED[name][1] if name in _PORTED else None,
               default_size=size, no_classes=n, oe_only=oe_only)
    for name, size, n, oe_only in (
        ("cifar10", 32, 10, False), ("cifar100", 32, 100, False), ("mnist", 28, 10, False),
        ("emnist", 28, 26, False), ("fmnist", 28, 10, False), ("imagenet", 256, 30, False),
        ("imagenet21k", 256, 21811, False), ("imagenet21ksubset", 256, 21811, False),
        ("imagenetoe", 256, 1000, True), ("tinyimages", 32, 1, False), ("mvtec", 256, 15, False),
        ("dtd", 256, 47, False), ("cub", 256, 200, False), ("custom", 256, None, False))
}


def _resolve_class(name: str):
    entry = DS_CHOICES[name]
    if entry["module"] is None:
        raise NotImplementedError(f"the {name!r} dataset is not ported yet")
    return getattr(importlib.import_module(entry["module"]), entry["cls"])


class MSM:
    """Multi-scale mode: a filter transform (``ops.filters``) on one dataset
    part, in the string form 'TRANSFORM+DSPART--M'."""

    def __init__(self, transform: str, ds_part: str, magnitude: Optional[int] = None):
        assert transform in MSM_TRANSFORMS, f"{transform} not in {MSM_TRANSFORMS}"
        assert ds_part in DS_PARTS, f"{ds_part} not in {list(DS_PARTS)}"
        self.transform_str = transform
        self.ds_part_str = ds_part
        self.ds_part = DS_PARTS[ds_part]
        self.magnitude = magnitude

    def set_magnitude(self, magnitude: int) -> "MSM":
        self.magnitude = magnitude
        return self

    def get_spec(self) -> dict:
        """The transform spec of ``ops.preprocess``."""
        assert self.magnitude is not None, "MSM magnitude not set"
        if self.transform_str == "blur":
            return {"op": "blur", "sigma": float(self.magnitude)}
        if self.transform_str == "sharpen":
            return {"op": "sharpen", "percent": float(self.magnitude) * 100.0}
        return {"op": self.transform_str, "magnitude": int(self.magnitude)}

    def __str__(self):
        return "+".join((self.transform_str, self.ds_part_str)) + f"--M{self.magnitude}"

    __repr__ = __str__

    @staticmethod
    def load(msm: str, load_magnitude: bool = True) -> "MSM":
        transform, ds_part = msm.split("+")
        magnitude = None
        if "--M" in ds_part:
            ds_part, magnitude = ds_part.split("--M")
        res = MSM(transform, ds_part)
        if load_magnitude and magnitude is not None and magnitude != "None":
            res.set_magnitude(int(magnitude))
        return res


def get_raw_shape(train_specs: Sequence, dataset_name: str) -> Tuple[int, int, int]:
    """The raw NHWC image shape: from a leading resize spec, else the
    registry's default size."""
    specs = list(train_specs or ())
    if specs:
        s = specs[0] if isinstance(specs[0], dict) else {"op": specs[0]}
        if s.get("op") == "resize":
            size = s["size"]
            return (size, size, 3) if isinstance(size, int) else (*tuple(size), 3)
    size = DS_CHOICES[dataset_name]["default_size"]
    return (size, size, 3)


def load_dataset(dataset_name: str, data_path: str, normal_classes: List[int],
                 nominal_label: int, train_specs: Sequence, test_specs: Sequence, logger=None,
                 oe_name: Optional[str] = None,
                 oe_limit_samples: Union[int, float, Sequence[int]] = float("inf"),
                 oe_limit_classes: Union[int, float] = float("inf"),
                 msms: Sequence[MSM] = (), ds_statistics: Optional[dict] = None,
                 rng: Optional[np.random.Generator] = None):
    """The normal dataset, and with ``oe_name`` a ``CombinedDataset`` of it
    and an OE dataset. The OE dataset takes the normal one's pipeline specs
    and statistics, trains with the flipped label, owns ``oe_limit_samples``,
    and with ``oe_limit_classes`` keeps that many of its classes, drawn
    from ``rng``. Each MSM becomes a conditional on its part: train_nominal
    on the normal train images (label ``nominal_label``), test_nominal and
    test_anomalous on the test images of that label or of the other, and
    train_oe on every OE train image."""
    from eoe_tpu_torch.datasets.bases import CombinedDataset
    assert dataset_name in DS_CHOICES, f"{dataset_name} is not in {sorted(DS_CHOICES)}"
    rng = rng if rng is not None else np.random.default_rng()
    raw_shape = get_raw_shape(train_specs, dataset_name)
    train_conditional = [(nominal_label, [m.get_spec()], None)
                         for m in msms if m.ds_part == TRAIN_NOMINAL_ID]
    test_conditional = [
        (nominal_label,
         [m.get_spec()] if m.ds_part == TEST_NOMINAL_ID else None,
         [m.get_spec()] if m.ds_part == TEST_ANOMALOUS_ID else None)
        for m in msms if m.ds_part in (TEST_NOMINAL_ID, TEST_ANOMALOUS_ID)]
    if DS_CHOICES[dataset_name]["oe_only"]:
        raise ValueError(f"{dataset_name} can only be used as OE!")
    dataset = _resolve_class(dataset_name)(
        data_path, list(normal_classes), nominal_label, list(train_specs or ()),
        list(test_specs or ()), raw_shape, logger, float("inf"), train_conditional,
        test_conditional, ds_statistics, rng)
    if oe_name is None:
        return dataset

    oe_cls = _resolve_class(oe_name)
    n_oe_classes = DS_CHOICES[oe_name]["no_classes"]
    if oe_limit_classes < float("inf"):
        oe_classes = sorted(rng.choice(np.arange(n_oe_classes),
                                       min(n_oe_classes, int(oe_limit_classes)),
                                       replace=False).tolist())
    else:
        oe_classes = list(range(n_oe_classes))
    oe_train_conditional = [(nominal_label, [m.get_spec()], [m.get_spec()])
                            for m in msms if m.ds_part == TRAIN_OE_ID]
    oe = oe_cls(data_path, oe_classes, 1 - nominal_label, deepcopy(dataset.train_specs),
                deepcopy(dataset.test_specs), raw_shape, logger, oe_limit_samples,
                oe_train_conditional, None, dataset.ds_statistics, rng)
    return CombinedDataset(dataset, oe)
