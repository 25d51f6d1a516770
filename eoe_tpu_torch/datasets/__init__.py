"""Datasets of the port: the registry and factory of
eoe_tpu/datasets/__init__.py, and in ``bases`` the AD dataset layer over
in-memory sources.

``load_dataset`` builds every registry entry by name: CIFAR-10, CIFAR-100,
MNIST, EMNIST (letters), Fashion-MNIST (``cifar``, ``mnist``), 80 Million
Tiny Images (``tinyimages``), ImageNet-30, ImageNet-21k and its prepared
subset (``imagenet``), ImageNet-1k as OE only (``imagenetoe``), MVTec-AD
(``mvtec``), DTD (``dtd``), CUB-200-2011 (``cub``) and custom image folders
(``custom``), with an OE dataset beside the normal one and the multi-scale
modes (``MSM``) as label-conditional pipelines, as the JAX package does. The
folder datasets read their images through ``folder`` (blobs, or decode with
a RAM cache). CUB's class names are read from its metadata when the dataset
is first built; the custom dataset's classes are its folders, which the
runners write into ``DS_CHOICES["custom"]``. The trainers also take a pinned
dataset (``trainer.ds``).
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

# the fixed class-label tables; CUB's names come from its metadata, the
# custom dataset's from its folders (``DS_CHOICES[...]["str_labels"]``)
STR_LABELS: Dict[str, List[str]] = {
    "cifar10": CIFAR10_LABELS, "cifar100": CIFAR100_LABELS, "mnist": MNIST_LABELS,
    "emnist": [str(i) for i in range(26)], "fmnist": FMNIST_LABELS,
    "imagenet": IMAGENET30_LABELS, "imagenet21k": [str(i) for i in range(21811)],
    "imagenet21ksubset": [str(i) for i in range(21811)],
    "imagenetoe": [str(i) for i in range(1000)], "tinyimages": ["tiny_image"],
    "mvtec": MVTEC_LABELS, "dtd": DTD_LABELS,
}


def str_labels(dataset_name: str) -> List[str]:
    labels = DS_CHOICES[dataset_name]["str_labels"]
    if labels is None and dataset_name == "cub":
        labels = importlib.import_module("eoe_tpu_torch.datasets.cub").cub_labels()
    if labels is None:
        raise ValueError(f"class labels of '{dataset_name}' depend on the data folder")
    return labels


def no_classes(dataset_name: str) -> int:
    n = DS_CHOICES[dataset_name]["no_classes"]
    if n is None:
        raise ValueError(f"number of classes of '{dataset_name}' depends on the data folder; "
                         f"use ADCustomDS.determine_classes")
    return n


# string ids of the filter transforms usable in MSMs
MSM_TRANSFORMS = ("blur", "sharpen", "hpf", "lpf")
TRAIN_NOMINAL_ID, TRAIN_OE_ID, TEST_NOMINAL_ID, TEST_ANOMALOUS_ID = 0, 1, 2, 3
DS_PARTS = {
    "train_nominal": TRAIN_NOMINAL_ID, "train_oe": TRAIN_OE_ID,
    "test_nominal": TEST_NOMINAL_ID, "test_anomalous": TEST_ANOMALOUS_ID,
}

_PORTED = {"cifar10": ("cifar", "ADCIFAR10"), "cifar100": ("cifar", "ADCIFAR100"),
           "mnist": ("mnist", "ADMNIST"), "emnist": ("mnist", "ADEMNIST"),
           "fmnist": ("mnist", "ADFMNIST"), "imagenet": ("imagenet", "ADImageNet"),
           "imagenet21k": ("imagenet", "ADImageNet21k"),
           "imagenet21ksubset": ("imagenet", "ADImageNet21kSubSet"),
           "imagenetoe": ("imagenetoe", "ADImageNetOE"),
           "tinyimages": ("tinyimages", "ADTinyImages"), "mvtec": ("mvtec", "ADMvTec"),
           "dtd": ("dtd", "ADDTD"), "cub": ("cub", "ADCUB"), "custom": ("custom", "ADCustomDS")}

# the JAX package's registry: module and class (resolved at first use), raw
# size, class count, OE-only, class labels
DS_CHOICES: Dict[str, dict] = {
    name: dict(module=f"eoe_tpu_torch.datasets.{_PORTED[name][0]}", cls=_PORTED[name][1],
               default_size=size, no_classes=n, oe_only=oe_only,
               str_labels=STR_LABELS.get(name))
    for name, size, n, oe_only in (
        ("cifar10", 32, 10, False), ("cifar100", 32, 100, False), ("mnist", 28, 10, False),
        ("emnist", 28, 26, False), ("fmnist", 28, 10, False), ("imagenet", 256, 30, False),
        ("imagenet21k", 256, 21811, False), ("imagenet21ksubset", 256, 21811, False),
        ("imagenetoe", 256, 1000, True), ("tinyimages", 32, 1, False), ("mvtec", 256, 15, False),
        ("dtd", 256, 47, False), ("cub", 256, 200, False), ("custom", 256, None, False))
}


def _resolve_class(name: str):
    entry = DS_CHOICES[name]
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
    from ``rng``. The custom dataset as its own OE set takes the anomalous
    folders of the normal classes, with the nominal label (its samples carry
    their own labels), and refuses ``oe_limit_classes``. Each MSM becomes a
    conditional on its part: train_nominal on the normal train images (label
    ``nominal_label``), test_nominal and test_anomalous on the test images of
    that label or of the other, and train_oe on every OE train image."""
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
    is_custom_oe = dataset_name == "custom" and oe_name == "custom"
    if is_custom_oe:
        if oe_limit_classes < float("inf"):
            raise ValueError("Using the custom dataset with its own OE part cannot be "
                             "combined with limiting the OE classes.")
        oe_classes, oe_label = list(normal_classes), nominal_label
    else:
        if oe_limit_classes < float("inf") and n_oe_classes is not None:
            oe_classes = sorted(rng.choice(np.arange(n_oe_classes),
                                           min(n_oe_classes, int(oe_limit_classes)),
                                           replace=False).tolist())
        else:
            oe_classes = list(range(n_oe_classes)) if n_oe_classes is not None else []
        oe_label = 1 - nominal_label
    oe_train_conditional = [(nominal_label, [m.get_spec()], [m.get_spec()])
                            for m in msms if m.ds_part == TRAIN_OE_ID]
    oe = oe_cls(data_path, oe_classes, oe_label, deepcopy(dataset.train_specs),
                deepcopy(dataset.test_specs), raw_shape, logger, oe_limit_samples,
                oe_train_conditional, None, dataset.ds_statistics, rng,
                **({"oe": True} if is_custom_oe else {}))
    return CombinedDataset(dataset, oe)
