"""Datasets of the port: the class-label tables of the JAX package's
registry (eoe_tpu/datasets/__init__.py) and, in ``bases``, the AD dataset
layer over in-memory sources.

The on-disk dataset loaders (``load_dataset``: CIFAR, MNIST, ImageNet, the
folder datasets) are not ported yet; the trainers take a pinned dataset
(``trainer.ds``) built from ``bases``.
"""

from typing import Dict, List

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
