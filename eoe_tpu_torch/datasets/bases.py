"""Dataset abstractions: sources, AD datasets, normal ‖ OE combination and
the fixed-shape balanced batch sampler. The port of eoe_tpu/datasets/bases.py.

Label semantics are the JAX package's: normal classes -> nominal_label, all
others -> the anomalous label; negative raw labels ('unlabeled') stay -1; OE
datasets carry the flipped nominal label; ``limit_samples`` is an int (a
random subset) or an explicit index list that overrides the filter.

The sampler is numpy, as in the JAX package: the same seed gives the same
index plans bit for bit. Sources hold uint8 images in host memory or read
them from disk. A split is resident when its source says so (array sources
always; folder sources and blobs within their byte budgets, ``folder``):
the trainer moves it to the device once and gathers batches there, and
streams every other split from the host batch by batch.

A pipeline with a ``normalize`` (or ``gcn-normalize``) placeholder and no
``ds_statistics`` takes its statistics from the raw normal train split
(``metrics.channel_stats``; for GCN the range of the L1 global-contrast-
normalised images) and caches them per dataset class, norm mode and normal
classes in ``<root>/stats_cache.json``, the JAX package's file.
"""

import json
import os
import os.path as pt
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from eoe_tpu_torch.ops.filters import global_contrast_normalization
from eoe_tpu_torch.ops.metrics import channel_stats
from eoe_tpu_torch.ops.preprocess import (GCN_PLACEHOLDERS, NORM_PLACEHOLDERS, DatasetStats,
                                          compile_conditional, compile_pipeline)

INF = float("inf")
STD_NORM = 0
GCN_NORM = 1


def _op(spec) -> str:
    return (spec if isinstance(spec, str) else spec.get("op", "")).lower()


class DataSource:
    """A random-access image collection at a fixed raw shape (h, w, c), uint8.
    ``gather`` is the only access path: batch assembly is an index gather."""

    targets: np.ndarray  # int64 class labels, shape (n,)

    def __len__(self) -> int:
        raise NotImplementedError

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """uint8 images (len(indices), h, w, c)."""
        raise NotImplementedError

    @property
    def raw_shape(self) -> Tuple[int, int, int]:
        raise NotImplementedError

    @property
    def resident(self) -> bool:
        """Whether any split of this source may be moved to the device whole
        (array-backed sources)."""
        return False

    def fits_resident(self, n_items: int) -> bool:
        """Whether a split of ``n_items`` of this source may be gathered once
        and moved to the device whole. A split that may not streams: the
        trainer gathers its batches on the host. Cached folder sources accept
        splits within their RAM budget, blobs within theirs."""
        return self.resident


class ArraySource(DataSource):
    def __init__(self, images: np.ndarray, targets: np.ndarray):
        assert images.ndim == 4, f"expected (n, h, w, c), got {images.shape}"
        self.images = images
        self.targets = np.asarray(targets, dtype=np.int64)
        assert len(self.images) == len(self.targets)

    def __len__(self):
        return len(self.images)

    def gather(self, indices):
        return self.images[np.asarray(indices)]

    @property
    def raw_shape(self):
        return tuple(self.images.shape[1:])

    @property
    def resident(self):
        return True


class LazySource(DataSource):
    """A source backed by a loader: ``gather_fn(indices)`` returns the uint8
    images (a decoder of files, a memory map too large for the host), called
    at every gather. Never resident: its splits stream."""

    def __init__(self, n: int, raw_shape: Tuple[int, int, int], targets: np.ndarray,
                 gather_fn: Callable[[np.ndarray], np.ndarray]):
        self._n = n
        self._raw_shape = tuple(raw_shape)
        self.targets = np.asarray(targets, dtype=np.int64)
        self._gather = gather_fn

    def __len__(self):
        return self._n

    def gather(self, indices):
        return self._gather(np.asarray(indices))

    @property
    def raw_shape(self):
        return self._raw_shape


class Subset:
    """Indices into a source; the train split is always a Subset."""

    def __init__(self, source: DataSource, indices: Sequence[int]):
        self.source = source
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def gather(self, positions: np.ndarray) -> np.ndarray:
        return self.source.gather(self.indices[np.asarray(positions)])

    def gather_all(self) -> np.ndarray:
        return self.source.gather(self.indices)

    @property
    def targets(self) -> np.ndarray:
        return self.source.targets[self.indices]

    @property
    def sample_keys(self):
        """Per-sample string keys when the source provides them."""
        keys = getattr(self.source, "sample_keys", None)
        return None if keys is None else [keys[i] for i in self.indices]


class ADDataset:
    """An anomaly-detection view of a classification dataset: normal-class
    filtering, ``limit_samples``, binary targets and pipeline compilation."""

    # folder-backed datasets set this so random crops resample degenerate
    # (all-white-border) results
    degenerate_crop_guard = False

    def __init__(self, root: str, normal_classes: Sequence[int], nominal_label: int,
                 train_specs: Sequence, test_specs: Sequence, n_classes: int,
                 raw_shape: Tuple[int, int, int], logger=None,
                 limit_samples: Union[int, float, Sequence[int]] = INF,
                 train_conditional: Sequence = (), test_conditional: Sequence = (),
                 ds_statistics: Optional[dict] = None,
                 rng: Optional[np.random.Generator] = None):
        self.root = root
        self.normal_classes = tuple(normal_classes)
        normal_set = set(self.normal_classes)
        self.outlier_classes = [c for c in range(n_classes) if c not in normal_set]
        assert nominal_label in (0, 1)
        self.nominal_label = nominal_label
        self.anomalous_label = 1 - nominal_label
        self.logger = logger
        self.limit_samples = limit_samples
        self.raw_shape = tuple(raw_shape)
        self.n_classes = n_classes
        self.rng = rng if rng is not None else np.random.default_rng()
        self.train_specs = list(train_specs or ())
        self.test_specs = list(test_specs or ())
        self.train_conditional = list(train_conditional or ())
        self.test_conditional = list(test_conditional or ())
        self._train_set: Optional[Subset] = None
        self._test_set: Optional[Subset] = None
        self._stats: Optional[DatasetStats] = DatasetStats.from_json(ds_statistics)
        self._train_pipeline = self._test_pipeline = None
        self._train_cond_pipeline = self._test_cond_pipeline = None

    def create_subset(self, source: DataSource,
                      class_labels: Optional[np.ndarray] = None) -> Subset:
        """Normal-class filter + limit_samples."""
        labels = np.asarray(class_labels if class_labels is not None else source.targets)
        normal_idcs = np.argwhere(np.isin(labels, self.normal_classes)).flatten()
        if isinstance(self.limit_samples, (int, float)) and self.limit_samples < INF:
            k = min(int(self.limit_samples), len(normal_idcs))
            normal_idcs = np.sort(self.rng.choice(normal_idcs, k, replace=False))
        elif not isinstance(self.limit_samples, (int, float)):
            normal_idcs = np.asarray(self.limit_samples, dtype=np.int64)
        return Subset(source, normal_idcs)

    def _get_raw_train_set(self) -> Optional[Subset]:
        """The raw (unaugmented) normal train split the statistics come from."""
        return self._train_set

    def finalize(self):
        """Extract statistics if a pipeline holds a normalization placeholder
        and none were given, then compile all pipelines. Call after the train
        and test sets are set."""
        needs_stats = any(_op(s) in NORM_PLACEHOLDERS + GCN_PLACEHOLDERS
                          for s in self.train_specs + self.test_specs)
        if needs_stats and self._stats is None:
            self._stats = self._extract_stats()
        guard = self.degenerate_crop_guard
        self._train_pipeline = compile_pipeline(self.train_specs, self._stats, guard)
        self._test_pipeline = compile_pipeline(self.test_specs, self._stats, guard)
        self._train_cond_pipeline = compile_conditional(self.train_conditional, self._stats, guard)
        self._test_cond_pipeline = compile_conditional(self.test_conditional, self._stats, guard)
        return self

    def _extract_stats(self) -> DatasetStats:
        mode = GCN_NORM if any(_op(s).startswith("gcn")
                               for s in self.train_specs + self.test_specs) else STD_NORM
        cached = self._load_cached_stats(mode)
        if cached is not None:
            if self.logger is not None:
                self.logger.print(f"Use cached stats of training dataset with normal classes "
                                  f"{self.normal_classes}")
            return cached
        raw = self._get_raw_train_set()
        if raw is None:
            raise ValueError(
                "pipeline contains a normalization placeholder but this dataset cannot provide "
                "a raw train split to extract statistics from")
        images = raw.gather_all()
        if mode == STD_NORM:
            mean, std = channel_stats(images)
            stats = DatasetStats(tuple(mean.tolist()), tuple(std.tolist()), STD_NORM)
        else:
            x = global_contrast_normalization(torch.from_numpy(images).float() / 255.0, "l1")
            tmin, tmax = float(x.min()), float(x.max())
            c = images.shape[-1]
            stats = DatasetStats((tmin,) * c, (tmax - tmin,) * c, GCN_NORM)
        self._cache_stats(stats, mode)
        return stats

    def _stats_cache_file(self) -> Optional[str]:
        return pt.join(self.root, "stats_cache.json") if self.root else None

    def _load_cached_stats(self, mode: int) -> Optional[DatasetStats]:
        file = self._stats_cache_file()
        if not file or not pt.exists(file):
            return None
        try:
            with open(file) as r:
                cache = json.load(r)
            entry = cache[type(self).__name__][str(mode)][json.dumps(list(self.normal_classes))]
            return DatasetStats(tuple(entry[0]), tuple(entry[1]), mode)
        except (KeyError, json.JSONDecodeError):
            return None

    def _cache_stats(self, stats: DatasetStats, mode: int):
        file = self._stats_cache_file()
        if not file:
            return
        cache = {}
        if pt.exists(file):
            try:
                with open(file) as r:
                    cache = json.load(r)
            except json.JSONDecodeError:
                cache = {}
        cache.setdefault(type(self).__name__, {}).setdefault(str(mode), {})[
            json.dumps(list(self.normal_classes))] = (list(stats.mean), list(stats.std))
        os.makedirs(pt.dirname(file), exist_ok=True)
        part = f"{file}.{os.getpid()}"   # whole or not at all: ranks share the file
        with open(part, "w") as w:
            json.dump(cache, w)
        os.replace(part, file)

    @property
    def train_set(self) -> Subset:
        return self._train_set

    @property
    def test_set(self) -> Subset:
        return self._test_set

    @property
    def ds_statistics(self) -> Optional[dict]:
        return self._stats.to_json() if self._stats is not None else None

    @property
    def stats(self) -> Optional[DatasetStats]:
        return self._stats

    @property
    def train_pipeline(self):
        return self._train_pipeline

    @property
    def test_pipeline(self):
        return self._test_pipeline

    @property
    def train_conditional_pipeline(self):
        return self._train_cond_pipeline

    @property
    def test_conditional_pipeline(self):
        return self._test_cond_pipeline

    def binary_targets(self, subset: Subset) -> np.ndarray:
        """Class labels -> nominal/anomalous; negative raw labels stay -1."""
        t = subset.targets
        out = np.where(np.isin(t, self.normal_classes), self.nominal_label, self.anomalous_label)
        return np.where(t < 0, -1, out).astype(np.int64)

    def n_normal_anomalous(self, train: bool = True) -> Dict[int, int]:
        subset = self._train_set if train else self._test_set
        keys, counts = np.unique(self.binary_targets(subset), return_counts=True)
        return {int(k): int(v) for k, v in zip(keys, counts)}

    def preview(self, percls: int = 20, train: bool = True) -> np.ndarray:
        """Raw uint8 images of the train (or test) split, up to ``percls`` of
        each binary class in class order, every class cut to the smallest
        one's count: (n, h, w, c). The pipelines are not applied."""
        subset = self._train_set if train else self._test_set
        binary = self.binary_targets(subset)
        out = [subset.gather(np.argwhere(binary == c).flatten()[:percls])
               for c in sorted(set(binary.tolist()))]
        n = min(len(o) for o in out)
        return np.concatenate([o[:n] for o in out])

    def __repr__(self):
        return type(self).__name__


class GenericADDataset(ADDataset):
    """ADDataset over explicit sources."""

    def __init__(self, train_source: DataSource, test_source: Optional[DataSource], **kw):
        super().__init__(**kw)
        self._train_source = train_source
        self._test_source = test_source
        self._train_set = self.create_subset(train_source)
        if test_source is not None:
            self._test_set = Subset(test_source, np.arange(len(test_source)))
        self.finalize()


class CombinedDataset:
    """Normal dataset + OE dataset: the test split is the normal one's; train
    batches are assembled half and half by the BalancedEpochSampler."""

    def __init__(self, normal: ADDataset, oe: ADDataset):
        self.normal = normal
        self.oe = oe
        self.nominal_label = normal.nominal_label
        self.anomalous_label = normal.anomalous_label
        self.normal_classes = normal.normal_classes
        self.outlier_classes = normal.outlier_classes
        self.raw_shape = normal.raw_shape
        self.logger = normal.logger
        self.limit_samples = oe.limit_samples

    @property
    def train_set(self):
        return self.normal.train_set

    @property
    def test_set(self):
        return self.normal.test_set

    @property
    def ds_statistics(self):
        return self.normal.ds_statistics

    def n_normal_anomalous(self, train: bool = True) -> Dict[int, int]:
        if not train:
            return self.normal.n_normal_anomalous(False)
        n = self.normal.n_normal_anomalous(True)
        # every OE sample counts as anomalous whatever its raw class
        o = {self.anomalous_label: len(self.oe.train_set)}
        return {k: n.get(k, 0) + o.get(k, 0) for k in set(n) | set(o)}

    def __repr__(self):
        return f"CombinedDataset({self.normal!r}, {self.oe!r})"


class BalancedEpochSampler:
    """Per-epoch fixed-shape index plans for balanced normal ‖ OE batches.

      * normal indices: a fresh shuffle each epoch, ceil(N / B) steps; the
        short last batch is padded by wrapping around and masked out,
      * OE indices: the OE index list repeated ceil(N / n_oe) times when it is
        shorter than the normal set, reshuffled each epoch, consumed in
        lockstep with the normal stream and cut to the normal half's size.

    ``epoch()`` returns positions into the two Subsets, each (steps, B), and
    a {0, 1} weight mask of the same shape marking real slots."""

    def __init__(self, n_normal: int, n_oe: int, batch_size: int, seed: int):
        assert n_normal > 0, "empty normal train set"
        self.n_normal = n_normal
        self.n_oe = n_oe
        self.batch_size = batch_size
        self.steps = int(np.ceil(n_normal / batch_size))
        self.rng = np.random.default_rng(seed)
        if 0 < n_oe < n_normal:
            self._oe_base = np.tile(np.arange(n_oe), int(np.ceil(n_normal / n_oe)))
        elif n_oe > 0:
            self._oe_base = np.arange(n_oe)
        else:
            self._oe_base = None

    def epoch(self) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        B, steps, N = self.batch_size, self.steps, self.n_normal
        total = steps * B
        normal = self.rng.permutation(N)
        weights = np.ones(total, dtype=np.float32)
        if total > N:
            normal = np.tile(normal, int(np.ceil(total / N)))[:total]
            weights[N:] = 0.0
        oe = None
        if self._oe_base is not None:
            oe = self.rng.permutation(self._oe_base)
            while len(oe) < total:
                oe = np.concatenate([oe, self.rng.permutation(self._oe_base)])
            oe = oe[:total].reshape(steps, B)
        return normal.reshape(steps, B), oe, weights.reshape(steps, B)
