"""CIFAR-10 / CIFAR-100 AD datasets: the port of eoe_tpu/datasets/cifar.py.

The python-pickle batch files are parsed directly (no torchvision); images
are one uint8 NHWC array in host memory, which the trainer moves to the
device once.

Expected on-disk layout under ``root``:
  cifar10:  cifar-10-batches-py/{data_batch_1..5, test_batch}
  cifar100: cifar-100-python/{train, test}
(or the ``.tar.gz`` archives beside them, extracted on first use).
``EOE_TPU_FAKE_DATA=1`` substitutes small deterministic synthetic data, the
JAX package's bytes exactly (the same numpy seed), for offline runs.
"""

import os
import os.path as pt
import pickle
import tarfile
from typing import Tuple

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, ArraySource, Subset


def _fake_arrays(n_classes: int, n_train: int = 200, n_test: int = 100, hw: int = 32,
                 c: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed + n_classes)

    def make(n):
        imgs = rng.integers(0, 256, size=(n, hw, hw, c), dtype=np.uint8)
        targets = rng.integers(0, n_classes, size=(n,))
        # make class identity weakly visible so AUROC is learnable in tests
        imgs = (imgs * 0.5 + (targets[:, None, None, None]
                              * (255 / max(n_classes - 1, 1))) * 0.5).astype(np.uint8)
        return imgs, targets
    return make(n_train), make(n_test)


def use_fake_data() -> bool:
    return os.environ.get("EOE_TPU_FAKE_DATA", "0") == "1"


def _maybe_extract(root: str, archive: str, member_dir: str):
    arch = pt.join(root, archive)
    if not pt.isdir(pt.join(root, member_dir)) and pt.exists(arch):
        with tarfile.open(arch) as tf:
            tf.extractall(root)


def _read_batches(base: str, files, label_key: bytes):
    xs, ys = [], []
    for f in files:
        with open(pt.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[label_key])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(ys, dtype=np.int64)


def load_cifar10(root: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    base = pt.join(root, "cifar-10-batches-py")
    _maybe_extract(root, "cifar-10-python.tar.gz", "cifar-10-batches-py")
    if not pt.isdir(base):
        raise FileNotFoundError(
            f"CIFAR-10 not found at {base}. Place cifar-10-python.tar.gz from "
            f"https://www.cs.toronto.edu/~kriz/cifar.html in {root}, "
            f"or set EOE_TPU_FAKE_DATA=1 for synthetic data.")
    xtr, ytr = _read_batches(base, [f"data_batch_{i}" for i in range(1, 6)], b"labels")
    xte, yte = _read_batches(base, ["test_batch"], b"labels")
    return xtr, ytr, xte, yte


def load_cifar100(root: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    base = pt.join(root, "cifar-100-python")
    _maybe_extract(root, "cifar-100-python.tar.gz", "cifar-100-python")
    if not pt.isdir(base):
        raise FileNotFoundError(
            f"CIFAR-100 not found at {base}. Place cifar-100-python.tar.gz in {root}, "
            f"or set EOE_TPU_FAKE_DATA=1 for synthetic data.")
    xtr, ytr = _read_batches(base, ["train"], b"fine_labels")
    xte, yte = _read_batches(base, ["test"], b"fine_labels")
    return xtr, ytr, xte, yte


class ArrayADDataset(ADDataset):
    """An AD dataset over whole train and test arrays, read by ``_arrays``
    from ``<root>/<SUBDIR>`` (or made by ``_fake_arrays``)."""

    N_CLASSES = 10
    SUBDIR = ""

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.SUBDIR) if root else root
        super().__init__(
            root=ds_root, normal_classes=normal_classes, nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=self.N_CLASSES,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        xtr, ytr, xte, yte = self._arrays(ds_root)
        self._train_source = ArraySource(xtr, ytr)
        self._test_source = ArraySource(xte, yte)
        self._train_set = self.create_subset(self._train_source)
        self._test_set = Subset(self._test_source, np.arange(len(self._test_source)))
        self.finalize()

    def _arrays(self, root: str):
        raise NotImplementedError


class _CifarBase(ArrayADDataset):
    def _arrays(self, root):
        if use_fake_data():
            (xtr, ytr), (xte, yte) = _fake_arrays(self.N_CLASSES)
            return xtr, ytr, xte, yte
        return self._load(root)


class ADCIFAR10(_CifarBase):
    N_CLASSES = 10
    SUBDIR = "cifar10"

    def _load(self, root):
        return load_cifar10(root)


class ADCIFAR100(_CifarBase):
    N_CLASSES = 100
    SUBDIR = "cifar100"

    def _load(self, root):
        return load_cifar100(root)
