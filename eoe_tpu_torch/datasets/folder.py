"""Folder-backed image sources: the port of eoe_tpu/datasets/folder.py.

A :class:`FolderSource` decodes a requested index batch on the host, in one
call of the native batch decoder (``eoe_tpu_torch.native``) where it is
available and with a thread pool over PIL otherwise, resizes every image to
the dataset's square raw shape once, and serves uint8 NHWC arrays; the
trainer moves them to the card, where the pipelines augment them. A
byte-budgeted RAM cache of decoded images (``EOE_TPU_FOLDER_CACHE_MB``)
serves later epochs, and a split within the budget is resident: the trainer
gathers it once and moves it to the device whole. A source with
``shm_prefix`` reads a cache server's shared-memory blocks
(``utils.caching``) before the disk. A file that fails to decode is logged
and the next index is served in its place.

A :class:`BlobSource` is the same tree decoded once at prepare time into one
uint8 ``.npy`` (``build_blob``) with a ``.json`` sidecar that keeps the scan
order; its gathers are memory-mapped reads, and splits up to
``EOE_TPU_BLOB_RESIDENT_MB`` are resident.

Images are resized to a square raw shape at decode (PIL's bilinear filter;
the native decoder computes Pillow's taps), as in the JAX package. One
deviation: the port admits a batch's decoded images into the RAM cache in
index order under a lock, where the JAX package's PIL path admits them from
its decode threads in the order they finish, without one; which images a
full budget keeps is therefore fixed here.
"""

import json
import os
import os.path as pt
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eoe_tpu_torch.datasets.bases import DataSource

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")

# listing a large tree takes time and the trainer rebuilds its datasets for
# every class-seed, so scans are kept per root
_SCAN_CACHE: Dict[str, Tuple[list, np.ndarray, list]] = {}


def scan_image_folder(root: str, use_cache: bool = True
                      ) -> Tuple[List[str], np.ndarray, List[str]]:
    """An ImageFolder-style scan, one class per subdirectory in alphabetical
    order: (paths, targets, classes)."""
    root = pt.abspath(root)
    if use_cache and root in _SCAN_CACHE:
        return _SCAN_CACHE[root]
    if not pt.isdir(root):
        raise FileNotFoundError(f"image folder not found: {root}")
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    paths: List[str] = []
    targets: List[int] = []
    for ci, cls in enumerate(classes):
        for dirpath, _, filenames in sorted(os.walk(pt.join(root, cls))):
            for fn in sorted(filenames):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    paths.append(pt.join(dirpath, fn))
                    targets.append(ci)
    result = (paths, np.asarray(targets, dtype=np.int64), classes)
    if use_cache:
        _SCAN_CACHE[root] = result
    return result


def blob_path(folder: str, hw: Tuple[int, int]) -> str:
    """The blob of a class-folder tree at raw size ``hw``: every image decoded
    and resized once into one memory-mappable uint8 ``.npy``."""
    return pt.join(pt.abspath(folder), f"_eoe_blob_{hw[0]}x{hw[1]}.npy")


def build_blob(folder: str, hw: Tuple[int, int], channels: int = 3,
               workers: int = 16, batch: int = 512) -> str:
    """Decode the whole tree into its blob, with a ``.json`` sidecar holding
    the classes, targets and relative paths in scan order, so loaders never
    scan again. Written to ``.tmp`` files and renamed."""
    paths, targets, classes = scan_image_folder(folder, use_cache=False)
    if not paths:
        raise FileNotFoundError(f"no images under {folder}")
    out = blob_path(folder, hw)
    src = FolderSource(paths, targets, (hw[0], hw[1], channels), cache_bytes=0,
                       workers=workers)
    arr = np.lib.format.open_memmap(out + ".tmp", mode="w+", dtype=np.uint8,
                                    shape=(len(paths), hw[0], hw[1], channels))
    for i in range(0, len(paths), batch):
        idx = np.arange(i, min(i + batch, len(paths)))
        arr[i:i + len(idx)] = src.gather(idx)
    arr.flush()
    del arr
    root = pt.abspath(folder)
    with open(out + ".json.tmp", "w") as f:
        json.dump({"classes": classes,
                   "targets": targets.tolist(),
                   "paths": [pt.relpath(p, root) for p in paths]}, f)
    os.replace(out + ".json.tmp", out + ".json")
    os.replace(out + ".tmp", out)
    return out


def load_blob_source(folder: str, raw_shape: Tuple[int, int, int], logger=None):
    """(BlobSource, targets, classes) when a blob of ``raw_shape`` exists,
    else None. An RGB blob serves a grayscale raw shape by slicing channels."""
    bp = blob_path(folder, raw_shape[:2])
    if not (pt.exists(bp) and pt.exists(bp + ".json")):
        return None
    with open(bp + ".json") as f:
        meta = json.load(f)
    arr = np.load(bp, mmap_mode="r")
    if arr.shape[1:3] != tuple(raw_shape[:2]) or arr.shape[3] < raw_shape[2]:
        return None
    if len(arr) != len(meta["targets"]):
        if logger is not None:
            logger.warning(f"blob {bp} is inconsistent with its sidecar; ignoring")
        return None
    targets = np.asarray(meta["targets"], np.int64)
    src = BlobSource(arr, targets, raw_shape, paths=meta["paths"])
    return src, targets, meta["classes"]


class BlobSource(DataSource):
    """A memory-mapped blob: gathers are page-in reads, no decode."""

    RESIDENT_BYTES = int(os.environ.get("EOE_TPU_BLOB_RESIDENT_MB", "4096")) << 20

    def __init__(self, images, targets: np.ndarray, raw_shape: Tuple[int, int, int],
                 paths=None):
        self.images = images  # np.memmap (n, h, w, C >= c)
        self.targets = np.asarray(targets, np.int64)
        self._raw_shape = tuple(raw_shape)
        self.paths = paths

    def __len__(self):
        return len(self.images)

    @property
    def raw_shape(self):
        return self._raw_shape

    def gather(self, indices):
        out = self.images[np.asarray(indices)]
        if out.shape[-1] != self._raw_shape[2]:
            out = np.ascontiguousarray(out[..., :self._raw_shape[2]])
        return out

    def fits_resident(self, n_items: int) -> bool:
        return int(n_items) * int(np.prod(self._raw_shape)) <= self.RESIDENT_BYTES


def decode_image(path: str, hw: Tuple[int, int], gray: bool = False) -> np.ndarray:
    """Decode, convert to RGB (or L) and square-resize one image: uint8 (h, w, c)."""
    from PIL import Image
    with Image.open(path) as img:
        img = img.convert("L" if gray else "RGB")
        if img.size != (hw[1], hw[0]):
            img = img.resize((hw[1], hw[0]), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.uint8)
    if gray:
        arr = arr[..., None]
    return arr


class FolderSource(DataSource):
    """Random access over image files: batch decode on the host and a
    byte-budgeted RAM cache of decoded (already resized) images."""

    # the RAM budget of decoded images per source when the constructor is not
    # given one (EOE_TPU_FOLDER_CACHE_MB; 0 turns the cache off). One host
    # core decodes a few hundred 224^2 JPEGs a second, far below what the card
    # trains, so epochs after the first should come from RAM
    DEFAULT_CACHE_BYTES = int(os.environ.get("EOE_TPU_FOLDER_CACHE_MB", "2048")) << 20

    def __init__(self, paths: Sequence[str], targets: np.ndarray,
                 raw_shape: Tuple[int, int, int], logger=None,
                 cache_bytes: Optional[int] = None, workers: int = 16,
                 sample_keys: Optional[Sequence[str]] = None,
                 shm_prefix: Optional[str] = None):
        self.paths = list(paths)
        self.targets = np.asarray(targets, dtype=np.int64)
        self._raw_shape = tuple(raw_shape)
        self.logger = logger
        self.cache_bytes = (self.DEFAULT_CACHE_BYTES if cache_bytes is None
                            else cache_bytes)
        self.workers = workers
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()
        # per-sample string keys of the score files (the custom datasets' paths
        # relative to their split folder)
        self.sample_keys = list(sample_keys) if sample_keys is not None else None
        # the cache server's block prefix '{ds}_{split}' (utils.caching); when
        # set, a decode reads the server's block before the disk
        self.shm_prefix = shm_prefix

    def __len__(self):
        return len(self.paths)

    @property
    def raw_shape(self):
        return self._raw_shape

    def _admit(self, index: int, arr: np.ndarray) -> bool:
        """Keep a decoded image if the budget allows; whether it is cached."""
        with self._cache_lock:
            if index in self._cache:
                return True
            if self._cache_used + arr.nbytes > self.cache_bytes:
                return False
            self._cache[index] = arr
            self._cache_used += arr.nbytes
            return True

    def _decode_one(self, index: int, admit: bool = True) -> np.ndarray:
        cached = self._cache.get(index)
        if cached is not None:
            return cached
        hw = self._raw_shape[:2]
        gray = self._raw_shape[2] == 1
        if self.shm_prefix is not None:
            from eoe_tpu_torch.utils.caching import read_shm_image
            img = read_shm_image(f"{self.shm_prefix}_{int(index)}")
            if img is not None:
                if img.shape[:2] != hw:  # the server may store another size
                    from PIL import Image
                    img = np.asarray(Image.fromarray(img).resize((hw[1], hw[0])),
                                     np.uint8)
                return img if not gray else img[..., :1]
        i = int(index)
        for _ in range(len(self.paths)):
            try:
                arr = decode_image(self.paths[i], hw, gray)
                break
            except Exception as e:  # a corrupt file: serve the next index
                if self.logger is not None:
                    self.logger.warning(
                        f"could not load picture at {self.paths[i]} ({e}); using next index",
                        print_msg=False)
                i = (i + 1) % len(self.paths)
        else:
            raise RuntimeError("all images in the folder source failed to decode")
        if admit:
            self._admit(index, arr)
        return arr

    def fits_resident(self, n_items: int) -> bool:
        """A split within the RAM budget is gathered once (one batch decode)
        and moved to the device whole, instead of streaming step by step."""
        return int(n_items) * int(np.prod(self._raw_shape)) <= self.cache_bytes

    def gather(self, indices: np.ndarray) -> np.ndarray:
        indices = np.asarray(indices)
        if self.shm_prefix is None and len(indices) >= 2 and self.cache_bytes:
            # decode only the uncached indices, in one native call where
            # possible, and keep what the budget allows, in index order
            uniq = [int(i) for i in dict.fromkeys(indices.tolist())]
            missing = [i for i in uniq if i not in self._cache]
            got = self._gather_native(np.asarray(missing)) if len(missing) >= 2 else None
            if got is None and missing:  # no native decoder, or one index: threaded PIL
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    got = list(pool.map(partial(self._decode_one, admit=False), missing))
            extra = {i: arr for i, arr in zip(missing, got if missing else ())
                     if not self._admit(i, arr)}
            return np.stack([self._cache[int(i)] if int(i) in self._cache
                             else extra[int(i)] for i in indices])
        native = self._gather_native(indices)
        if native is not None:
            return native
        if len(indices) == 1:
            return self._decode_one(int(indices[0]))[None]
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            imgs = list(pool.map(self._decode_one, indices.tolist()))
        return np.stack(imgs)

    def _gather_native(self, indices: np.ndarray) -> Optional[np.ndarray]:
        """One call of the native batch decoder (threaded libjpeg/libpng
        decode and resize, no GIL); an image it fails on is decoded with PIL.
        None without the library, for one index, or for a source read from a
        cache server's blocks."""
        if self.shm_prefix is not None or len(indices) < 2:
            return None
        from eoe_tpu_torch import native
        out, status = native.decode_batch_with_status(
            [self.paths[int(i)] for i in indices], self._raw_shape[:2],
            self._raw_shape[2], self.workers)
        if out is None:
            return None
        for j in np.flatnonzero(status):
            if self.logger is not None:
                self.logger.warning(
                    f"native decode failed for {self.paths[int(indices[j])]}; "
                    f"falling back to PIL", print_msg=False)
            out[j] = self._decode_one(int(indices[j]), admit=False)
        return out

    def warm_cache(self, indices: Sequence[int]):
        """Decode a set of indices into the RAM cache ahead of training."""
        for i in indices:
            if self._cache_used >= self.cache_bytes:
                break
            self._decode_one(int(i))
