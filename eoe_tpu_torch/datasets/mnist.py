"""MNIST / EMNIST-letters / FashionMNIST AD datasets with an idx-ubyte
parser: the port of eoe_tpu/datasets/mnist.py.

EMNIST uses the 'letters' split, transposes the raw images as torchvision
does, and remaps the letters' labels 1..26 to 0..25. ``EOE_TPU_FAKE_DATA=1``
substitutes the JAX package's synthetic 28x28x1 data.
"""

import gzip
import os.path as pt
import struct
from typing import Tuple

import numpy as np

from eoe_tpu_torch.datasets.cifar import ArrayADDataset, _fake_arrays, use_fake_data


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(root: str, names) -> str:
    for n in names:
        for suffix in ("", ".gz"):
            p = pt.join(root, n + suffix)
            if pt.exists(p):
                return p
    raise FileNotFoundError(
        f"none of {names} found under {root}; place the idx files there or set "
        f"EOE_TPU_FAKE_DATA=1")


def load_idx_dataset(root: str, prefix: str = ""
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    xtr = _read_idx(_find(root, [f"{prefix}train-images-idx3-ubyte", "train-images.idx3-ubyte"]))
    ytr = _read_idx(_find(root, [f"{prefix}train-labels-idx1-ubyte", "train-labels.idx1-ubyte"]))
    xte = _read_idx(_find(root, [f"{prefix}t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte",
                                 f"{prefix}test-images-idx3-ubyte"]))
    yte = _read_idx(_find(root, [f"{prefix}t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte",
                                 f"{prefix}test-labels-idx1-ubyte"]))
    return xtr[..., None], ytr.astype(np.int64), xte[..., None], yte.astype(np.int64)


class _IdxBase(ArrayADDataset):
    PREFIX = ""
    TRANSPOSE = False
    LABEL_OFFSET = 0

    def _arrays(self, root):
        if use_fake_data():
            (xtr, ytr), (xte, yte) = _fake_arrays(self.N_CLASSES, hw=28, c=1)
            return xtr, ytr, xte, yte
        xtr, ytr, xte, yte = load_idx_dataset(root, self.PREFIX)
        if self.TRANSPOSE:
            xtr = np.ascontiguousarray(xtr.transpose(0, 2, 1, 3))
            xte = np.ascontiguousarray(xte.transpose(0, 2, 1, 3))
        return xtr, ytr - self.LABEL_OFFSET, xte, yte - self.LABEL_OFFSET


class ADMNIST(_IdxBase):
    N_CLASSES = 10
    SUBDIR = "mnist"


class ADEMNIST(_IdxBase):
    N_CLASSES = 26
    SUBDIR = "emnist"
    PREFIX = "emnist-letters-"
    TRANSPOSE = True
    LABEL_OFFSET = 1


class ADFMNIST(_IdxBase):
    N_CLASSES = 10
    SUBDIR = "fmnist"
