"""80 Million Tiny Images as OE (the OE set of the CIFAR-10 benchmark): the
port of eoe_tpu/datasets/tinyimages.py.

The single binary ``<root>/tinyimages/tiny_images.bin`` holds 3072 bytes per
32x32x3 image, each channel stored column-major; it is memory-mapped once
and read by index. The known CIFAR near-duplicates listed (1-based) in
``80mn_cifar_idxs.txt`` beside it are left out; the surviving index list of
the full bin is cached there as ``tinyimages_valid_idxs.npy``. OE only: there
is no test split. The source streams: the trainer gathers its batches on the
host. ``EOE_TPU_FAKE_DATA=1`` substitutes 512 synthetic images, the JAX
package's bytes exactly.
"""

import os
import os.path as pt
from typing import Tuple

import numpy as np

from eoe_tpu_torch.datasets.bases import ADDataset, ArraySource, DataSource
from eoe_tpu_torch.datasets.cifar import use_fake_data

N_TINY = 79302017
N_FAKE = 512


class TinyImagesSource(DataSource):
    def __init__(self, bin_path: str, valid_indices: np.ndarray):
        self.bin_path = bin_path
        self.valid = np.asarray(valid_indices, dtype=np.int64)
        self.targets = np.zeros(len(self.valid), dtype=np.int64)  # one pseudo-class
        self._mm = None

    def _memmap(self) -> np.memmap:
        if self._mm is None:
            self._mm = np.memmap(self.bin_path, dtype=np.uint8, mode="r")
        return self._mm

    def __len__(self):
        return len(self.valid)

    @property
    def raw_shape(self) -> Tuple[int, int, int]:
        return (32, 32, 3)

    @property
    def resident(self) -> bool:
        return False

    def gather(self, indices: np.ndarray) -> np.ndarray:
        mm = self._memmap()
        out = np.empty((len(indices), 32, 32, 3), dtype=np.uint8)
        for j, i in enumerate(self.valid[np.asarray(indices)]):
            out[j] = mm[i * 3072:(i + 1) * 3072].reshape(3, 32, 32).transpose(2, 1, 0)
        return out


def load_valid_indices(root: str, n_records: int = N_TINY) -> np.ndarray:
    """Every record index of the bin but the CIFAR near-duplicates. The
    index space is the bin's own record count, so a partial copy is never
    read past its end; only the full bin's list is cached."""
    cache = pt.join(root, "tinyimages_valid_idxs.npy")
    if n_records == N_TINY and pt.exists(cache):
        return np.load(cache)
    excl_file = pt.join(root, "80mn_cifar_idxs.txt")
    mask = np.ones(n_records, dtype=bool)
    if pt.exists(excl_file):
        with open(excl_file) as f:
            excl = np.asarray([int(line) - 1 for line in f if line.strip()], dtype=np.int64)
        mask[excl[excl < n_records]] = False
    valid = np.flatnonzero(mask)
    if n_records == N_TINY:
        try:
            np.save(cache, valid)
        except OSError:
            pass
    return valid


def fake_images() -> np.ndarray:
    """The synthetic stand-in of ``EOE_TPU_FAKE_DATA=1``."""
    return np.random.default_rng(7).integers(0, 256, (N_FAKE, 32, 32, 3), dtype=np.uint8)


class ADTinyImages(ADDataset):
    base_folder = "tinyimages"

    def __init__(self, root: str, normal_classes, nominal_label, train_specs, test_specs,
                 raw_shape, logger=None, limit_samples=float("inf"),
                 train_conditional=(), test_conditional=(), ds_statistics=None, rng=None):
        ds_root = pt.join(root, self.base_folder)
        bin_path = pt.join(ds_root, "tiny_images.bin")
        fake = use_fake_data()
        if not fake and not pt.exists(bin_path):
            raise FileNotFoundError(
                f"80M TinyImages binary not found at {bin_path}. The dataset has been "
                f"withdrawn by its authors; if you hold a copy, place tiny_images.bin "
                f"and 80mn_cifar_idxs.txt there.")
        super().__init__(
            root=ds_root, normal_classes=[0], nominal_label=nominal_label,
            train_specs=train_specs, test_specs=test_specs, n_classes=1,
            raw_shape=raw_shape, logger=logger, limit_samples=limit_samples,
            train_conditional=train_conditional, test_conditional=test_conditional,
            ds_statistics=ds_statistics, rng=rng)
        if fake:
            self._train_source = ArraySource(fake_images(), np.zeros(N_FAKE, np.int64))
        else:
            n_records = os.path.getsize(bin_path) // 3072
            self._train_source = TinyImagesSource(
                bin_path, load_valid_indices(ds_root, n_records))
        self._train_set = self.create_subset(self._train_source)
        self._test_set = None  # OE only
        self.finalize()
