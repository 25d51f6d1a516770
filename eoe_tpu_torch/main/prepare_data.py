"""CLI: offline dataset/checkpoint preparation with integrity verification.
The port of eoe_tpu/main/prepare_data.py, over the port's own dataset
modules (``datasets.mvtec`` and ``datasets.folder`` blobs,
``datasets.imagenet``, ``datasets.custom``); the files it writes are the
ones the JAX package writes. A host tool: it reads, unpacks and decodes on
the CPU and touches no card.

The reference self-bootstraps its data online (torchvision downloads with md5
checks; MVTec tar.xz download + preprocessing, mvtec.py:194-256; CUB download
+ per-file integrity, cub.py:191-210; CLIP checkpoints with sha256
verification, clip_official/clip/clip.py:18-53). Without network access this
command is the offline half of that contract: the user supplies the
archives, we

  1. VERIFY them against the published digests (CLIP sha256 from the OpenAI
     URLs; torchvision md5 for CIFAR/DTD; idx-file md5 for MNIST/Fashion),
  2. UNPACK/place them into the raw layout the loaders expect
     (``<datapath>/datasets/<ds>/...``),
  3. CONVERT where a preprocessed form is used (the MVTec resized npz blob),
  4. CHECK the resulting layout (e.g. CUB's images.txt file-presence sweep).

Run:  python -m eoe_tpu_torch.main.prepare_data <dataset> <archive...>
          [--datapath DP] [--skip-hash] [--blob-resolution 224]
e.g.  python -m eoe_tpu_torch.main.prepare_data cifar10 ~/cifar-10-python.tar.gz
      python -m eoe_tpu_torch.main.prepare_data mvtec mvtec_anomaly_detection.tar.xz \
          --blob-resolution 224
      python -m eoe_tpu_torch.main.prepare_data clip ~/ViT-B-32.pt
"""

import argparse
import hashlib
import os
import os.path as pt
import shutil
import tarfile
import zipfile
from typing import Dict, Optional, Tuple

# ------------------------------------------------------- published digests

# sha256 prefixes from the OpenAI checkpoint URLs (reference clip.py:18-23)
CLIP_SHA256 = {
    "RN50.pt": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101.pt": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4.pt": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "ViT-B-32.pt": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
}

# md5 digests published by torchvision (the reference's download path)
ARCHIVE_MD5: Dict[str, str] = {
    "cifar-10-python.tar.gz": "c58f30108f718f92721af3b95e74349a",
    "cifar-100-python.tar.gz": "eb9058c3a382ffc7106e4002c42a8d85",
    "dtd-r1.0.1.tar.gz": "fff73e5086ae6bdbea199a49dfb8a4c1",
    # MNIST idx gzips (yann.lecun.com / torchvision mirrors)
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}
# FashionMNIST reuses the MNIST file names with different contents: keyed by
# (dataset, filename) where the plain filename would collide
DS_ARCHIVE_MD5: Dict[Tuple[str, str], str] = {
    ("fmnist", "train-images-idx3-ubyte.gz"): "8d4fb7e6c68d591d4c3dfef9ec88bf0d",
    ("fmnist", "train-labels-idx1-ubyte.gz"): "25c81989df183df01b3e8a0aad5dffbe",
    ("fmnist", "t10k-images-idx3-ubyte.gz"): "bef4ecab320f06d8554ea6380940ec79",
    ("fmnist", "t10k-labels-idx1-ubyte.gz"): "bb300cfdad3c16e7a12a480ee83cd310",
}

TINYIMAGES_BYTES = 79_302_017 * 3072  # tiny_images.bin record count x 3072B

# --download sources: the reference's own download endpoints (torchvision
# dataset URLs; MVTec mvtec.py:98 with its https->http retry :323-333; CUB
# cub.py:71; OpenAI CLIP checkpoints clip.py:18-23). Each entry is the list
# of files a dataset needs. ImageNet-30/21k and 80MTI have no public
# endpoint (login-walled / withdrawn) and stay archive-only.
DOWNLOAD_URLS: Dict[str, Tuple[str, ...]] = {
    "cifar10": ("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",),
    "cifar100": ("https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",),
    "mnist": tuple(
        f"https://ossci-datasets.s3.amazonaws.com/mnist/{fn}" for fn in (
            "train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
            "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")),
    "fmnist": tuple(
        "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/" + fn
        for fn in ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
                   "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")),
    "emnist": ("https://biometrics.nist.gov/cs_links/EMNIST/gzip.zip",),
    "dtd": ("https://www.robots.ox.ac.uk/~vgg/data/dtd/download/"
            "dtd-r1.0.1.tar.gz",),
    "cub": ("https://data.caltech.edu/records/65de6-vp158/files/"
            "CUB_200_2011.tgz",),
    "mvtec": ("https://www.mydrive.ch/shares/38536/"
              "3830184030e49fe74747669442f0f282/download/420938113-1629952094/"
              "mvtec_anomaly_detection.tar.xz",),
    # ViT-B/32 is the acceptance checkpoint; other CLIP variants can still be
    # supplied as archives
    "clip": ("https://openaipublic.azureedge.net/clip/models/"
             "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/"
             "ViT-B-32.pt",),
}


def fetch_url(url: str, dest: str, timeout: float = 30.0) -> str:
    """Stream one URL to dest (reference download_url shape). MVTec's server
    rejects https on some networks: retry http like mvtec.py:323-333."""
    import urllib.request

    os.makedirs(pt.dirname(dest) or ".", exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "eoe-tpu"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r, \
                open(dest, "wb") as f:
            shutil.copyfileobj(r, f)
    except Exception:
        if url.startswith("https://www.mydrive.ch"):
            return fetch_url("http://" + url[len("https://"):], dest, timeout)
        raise
    return dest


def download_archives(dataset: str, download_dir: str,
                      fetch=None) -> Optional[list]:
    """Fetch the dataset's published archives into download_dir; returns the
    local paths, or None (with a message) when the environment has no egress
    or the dataset has no public endpoint. Already-present files with a
    matching digest are not re-fetched."""
    fetch = fetch or fetch_url  # late-bound so tests can monkeypatch fetch_url
    urls = DOWNLOAD_URLS.get(dataset)
    if not urls:
        print(f"{dataset}: no public download endpoint "
              f"(supply the archives manually)")
        return None
    out = []
    for url in urls:
        dest = pt.join(download_dir, pt.basename(url))
        known = _known_digest(dataset, pt.basename(dest))
        if pt.isfile(dest) and known and file_digest(dest, known[0]) == known[1]:
            print(f"already downloaded: {dest}")
            out.append(dest)
            continue
        try:
            print(f"downloading {url} ...")
            fetch(url, dest)
        except Exception as e:
            print(f"download failed ({type(e).__name__}: {e}) — no egress? "
                  f"Supply the archives manually and re-run without --download.")
            return None
        out.append(dest)
    return out


def file_digest(path: str, algo: str = "md5", chunk: int = 1 << 20) -> str:
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_file(path: str, algo: str, expected: Optional[str], skip: bool = False):
    """Raises on digest mismatch; silently passes when no digest is known."""
    if expected is None or skip:
        return
    got = file_digest(path, algo)
    if got != expected:
        raise ValueError(
            f"{algo} mismatch for {path}:\n  expected {expected}\n  got      {got}\n"
            f"The archive is corrupt or not the published one "
            f"(pass --skip-hash to force).")
    print(f"verified {pt.basename(path)} ({algo}={expected[:12]}...)")


def _known_digest(dataset: str, filename: str) -> Optional[Tuple[str, str]]:
    if (dataset, filename) in DS_ARCHIVE_MD5:
        return "md5", DS_ARCHIVE_MD5[(dataset, filename)]
    if filename in CLIP_SHA256:
        return "sha256", CLIP_SHA256[filename]
    if filename in ARCHIVE_MD5:
        return "md5", ARCHIVE_MD5[filename]
    return None


def _extract(archive: str, dest: str):
    os.makedirs(dest, exist_ok=True)
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest)
    else:
        with tarfile.open(archive) as t:
            t.extractall(dest, filter="data")  # refuse path-escaping members
    print(f"extracted {pt.basename(archive)} -> {dest}")


def _place(archive: str, dest_dir: str) -> str:
    os.makedirs(dest_dir, exist_ok=True)
    dest = pt.join(dest_dir, pt.basename(archive))
    if pt.abspath(archive) != pt.abspath(dest):
        shutil.copy2(archive, dest)
    return dest


# ------------------------------------------------------------- handlers


def prepare_cifar(ds: str, archives, root: str, args) -> str:
    sub, member = (("cifar10", "cifar-10-batches-py") if ds == "cifar10"
                   else ("cifar100", "cifar-100-python"))
    dest = pt.join(root, sub)
    for a in archives:
        algo, dig = _known_digest(ds, pt.basename(a)) or ("md5", None)
        verify_file(a, algo, dig, args.skip_hash)
        _extract(a, dest)
    out = pt.join(dest, member)
    if not pt.isdir(out):
        raise FileNotFoundError(f"archive did not contain {member}/")
    return out


def prepare_idx(ds: str, archives, root: str, args) -> str:
    """MNIST/FashionMNIST: verify + place the idx gzips (the loaders read .gz
    directly). EMNIST: extract gzip.zip and lift the letters-split files."""
    sub = {"mnist": "mnist", "fmnist": "fmnist", "emnist": "emnist"}[ds]
    dest = pt.join(root, sub)
    os.makedirs(dest, exist_ok=True)
    for a in archives:
        if a.endswith(".zip"):
            tmp = pt.join(dest, "_tmp_zip")
            _extract(a, tmp)
            moved = 0
            for dirpath, _, files in os.walk(tmp):
                for f in files:
                    if "-ubyte" in f:
                        shutil.move(pt.join(dirpath, f), pt.join(dest, f))
                        moved += 1
            shutil.rmtree(tmp)
            print(f"placed {moved} idx files into {dest}")
        else:
            algo, dig = _known_digest(ds, pt.basename(a)) or ("md5", None)
            verify_file(a, algo, dig, args.skip_hash)
            _place(a, dest)
    return dest


def prepare_mvtec(ds: str, archives, root: str, args) -> str:
    dest = pt.join(root, "mvtec")
    for a in archives:
        verify_file(a, "sha256", None, args.skip_hash)  # no published digest
        _extract(a, dest)
    if args.blob_resolution:
        from eoe_tpu_torch.datasets.mvtec import build_blob
        hw = (args.blob_resolution, args.blob_resolution)
        print(f"building resized blob at {hw}...")
        build_blob(dest, hw)
    return dest


def prepare_cub(ds: str, archives, root: str, args) -> str:
    dest = pt.join(root, "cub")
    for a in archives:
        algo, dig = _known_digest(ds, pt.basename(a)) or ("md5", None)
        verify_file(a, algo, dig, args.skip_hash)
        _extract(a, dest)
    return _check_cub_tree(dest)


def _check_cub_tree(dest: str) -> str:
    """Per-file integrity sweep (reference cub.py:193-203)."""
    meta = pt.join(dest, "CUB_200_2011")
    images_txt = pt.join(meta, "images.txt")
    if not pt.exists(images_txt):
        raise FileNotFoundError(f"{images_txt} missing")
    missing = []
    with open(images_txt) as f:
        for line in f:
            if line.strip():
                rel = line.split(None, 1)[1].strip()
                if not pt.isfile(pt.join(meta, "images", rel)):
                    missing.append(rel)
    if missing:
        raise FileNotFoundError(
            f"CUB is corrupted: {len(missing)} files from images.txt are missing "
            f"(first: {missing[:3]}). Please re-obtain the archive "
            f"(cub.py:203-210 semantics).")
    print(f"CUB integrity OK ({sum(1 for _ in open(images_txt))} files verified)")
    return meta


def prepare_dtd(ds: str, archives, root: str, args) -> str:
    dest = pt.join(root, "dtd")
    for a in archives:
        algo, dig = _known_digest(ds, pt.basename(a)) or ("md5", None)
        verify_file(a, algo, dig, args.skip_hash)
        _extract(a, dest)
    out = pt.join(dest, "dtd")
    for req in ("images", "labels"):
        if not pt.isdir(pt.join(out, req)):
            raise FileNotFoundError(f"dtd archive did not contain dtd/{req}/")
    return out


def prepare_tinyimages(ds: str, archives, root: str, args) -> str:
    dest = pt.join(root, "tinyimages")
    os.makedirs(dest, exist_ok=True)
    out = None
    for a in archives:
        size = pt.getsize(a)
        if size != TINYIMAGES_BYTES and not args.skip_hash:
            raise ValueError(
                f"{a} is {size} bytes; the 80M TinyImages bin must be exactly "
                f"79302017*3072 = {TINYIMAGES_BYTES} (pass --skip-hash to force)")
        out = _place(a, dest)
        print(f"verified tiny_images.bin size ({size} bytes)")
    return out or dest


def prepare_clip(ds: str, archives, root: str, args) -> str:
    """Verify OpenAI CLIP checkpoints against the sha256 embedded in their
    publication URLs (clip.py:36-53) and place them for the loader."""
    dest = pt.join(pt.dirname(root), "clip_checkpoints") if root.endswith("datasets") \
        else pt.join(root, "clip_checkpoints")
    out = None
    for a in archives:
        algo_dig = _known_digest(ds, pt.basename(a))
        if algo_dig is None and not args.skip_hash:
            raise ValueError(
                f"unknown CLIP checkpoint name {pt.basename(a)}; expected one of "
                f"{sorted(CLIP_SHA256)} (pass --skip-hash to place it unverified)")
        if algo_dig is not None:
            verify_file(a, algo_dig[0], algo_dig[1], args.skip_hash)
        out = _place(a, dest)
        print(f"set EOE_TPU_CLIP_CHECKPOINT={out} to use it")
    return out or dest


def prepare_imagenet30(ds: str, archives, root: str, args) -> str:
    """ImageNet-30 (imagenet_ad/{train,val}): extract user archives into the
    layout, then validate it (the reference validates at load time via its
    hand-picked 30-class list, imagenet.py:27-30,60-66). With
    --blob-resolution N, additionally decode both splits into preprocessed
    array-shard blobs (datasets/folder.py build_blob) — the loaders prefer a
    matching blob, turning the per-epoch JPEG decode into memmap reads so
    the real-data input path can feed the chip's training rate."""
    dest = pt.join(root, "imagenet_ad")
    for a in archives:
        _extract(a, dest)
    out = check_imagenet30(root, args)
    if args.blob_resolution:
        from eoe_tpu_torch.datasets.folder import build_blob
        hw = (args.blob_resolution, args.blob_resolution)
        for split in ("train", "val"):
            print(f"building imagenet30 {split} blob at {hw}...")
            print("  ->", build_blob(pt.join(dest, split), hw))
    return out


def check_imagenet30(root: str, args) -> str:
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    dest = pt.join(root, "imagenet_ad")
    for split in ("train", "val"):
        sp = pt.join(dest, split)
        if not pt.isdir(sp):
            raise FileNotFoundError(
                f"{sp} missing; imagenet30 needs imagenet_ad/train and "
                f"imagenet_ad/val class-folder trees.")
        present = {d for d in os.listdir(sp) if pt.isdir(pt.join(sp, d))}
        missing = [c for c in AD_CLASSES if c not in present]
        if missing:
            raise FileNotFoundError(
                f"{sp} lacks {len(missing)} of the 30 AD classes "
                f"(first: {missing[:5]}; the loader remaps exactly these "
                f"folder names, reference imagenet.py:27-30).")
        empty = [c for c in AD_CLASSES if not os.listdir(pt.join(sp, c))]
        if empty:
            raise FileNotFoundError(f"{sp}: empty class folders {empty[:5]}")
        n = sum(len(os.listdir(pt.join(sp, c))) for c in AD_CLASSES)
        extra = len(present) - (30 - len(missing))
        print(f"imagenet30 {split}: 30/30 AD classes, {n} images"
              + (f" (+{extra} extra class folders, ignored by the loader)" if extra else ""))
        if args.blob_resolution:
            from eoe_tpu_torch.datasets.folder import blob_path
            bp = blob_path(sp, (args.blob_resolution, args.blob_resolution))
            print(f"imagenet30 {split} blob "
                  + (f"OK at {bp}" if pt.exists(bp) else
                     f"MISSING at {bp} (run without --check-only to build it)"))
    return dest


def prepare_imagenet21k(ds: str, archives, root: str, args) -> str:
    """ImageNet-21k OE pool (imagenet22k/fall11_whole_extracted/<wnid>/)."""
    from eoe_tpu_torch.datasets.imagenet import ADImageNet21k
    dest = pt.join(root, ADImageNet21k.base_folder)
    for a in archives:
        _extract(a, dest)
    return check_imagenet21k(root, args)


def check_imagenet21k(root: str, args) -> str:
    from eoe_tpu_torch.datasets.imagenet import IMAGENET1K_WNIDS, ADImageNet21k
    dest = pt.join(root, ADImageNet21k.base_folder)
    if not pt.isdir(dest):
        raise FileNotFoundError(
            f"{dest} missing; imagenet21k expects wnid class folders under "
            f"imagenet22k/fall11_whole_extracted/.")
    wnids = [d for d in os.listdir(dest)
             if pt.isdir(pt.join(dest, d)) and d.startswith("n")]
    if not wnids:
        raise FileNotFoundError(f"{dest} contains no n* wnid class folders.")
    overlap = sorted(set(wnids) & IMAGENET1K_WNIDS)
    print(f"imagenet21k: {len(wnids)} wnid folders; {len(overlap)} of the 30 "
          f"AD-class 1k synsets present (excluded at load, imagenet.py:378-387)")
    return dest


def prepare_imagenet21ksubset(ds: str, archives, root: str, args) -> str:
    """Pre-built 21k subset (imagenet21k_subset/): extract archives OR build
    from the full 21k tree with --build-subset N."""
    from eoe_tpu_torch.datasets.imagenet import (ADImageNet21kSubSet,
                                           build_imagenet21k_subset)
    dest = pt.join(root, ADImageNet21kSubSet.base_folder)
    for a in archives:
        _extract(a, dest)
    if args.build_subset:
        build_imagenet21k_subset(pt.dirname(root), per_class=args.build_subset,
                                 size=args.subset_size)
    out = check_imagenet21ksubset(root, args)
    if args.blob_resolution:
        from eoe_tpu_torch.datasets.folder import build_blob
        hw = (args.blob_resolution, args.blob_resolution)
        print(f"building imagenet21ksubset blob at {hw}...")
        print("  ->", build_blob(dest, hw))
    return out


def check_imagenet21ksubset(root: str, args) -> str:
    from eoe_tpu_torch.datasets.imagenet import ADImageNet21kSubSet
    dest = pt.join(root, ADImageNet21kSubSet.base_folder)
    if not pt.isdir(dest) or not any(
            pt.isdir(pt.join(dest, d)) for d in os.listdir(dest)):
        raise FileNotFoundError(
            f"{dest} missing or empty; build it with --build-subset N from a "
            f"prepared imagenet21k tree (or run "
            f"experiments/caching/create_imagenet21k_subset.py).")
    n_cls = sum(pt.isdir(pt.join(dest, d)) for d in os.listdir(dest))
    print(f"imagenet21ksubset: {n_cls} class folders at {dest}")
    return dest


def prepare_custom(ds: str, archives, root: str, args) -> str:
    """Custom dataset layouts: extract archives into <root>/custom/, then run
    the same validation the loaders apply (custom.py:221-299 check_data).
    Layout mode is auto-detected: class folders containing a normal/
    subfolder => general mode, else one-vs-rest; --train-only/--eval-only
    validate split-less roots."""
    dest = pt.join(root, "custom")
    for a in archives:
        _extract(a, dest)
    return check_custom(root, args)


def check_custom(root: str, args) -> str:
    from eoe_tpu_torch.datasets.custom import check_custom_layout
    dest = args.custom_root or pt.join(root, "custom")
    if args.train_only or args.eval_only:
        check_custom_layout(dest, ovr=False, train_only=args.train_only,
                            eval_only=args.eval_only)
        mode = "train-only" if args.train_only else "eval-only"
        print(f"custom ({mode}, split-less) layout OK at {dest}")
        return dest
    train = pt.join(dest, "train")
    if not pt.isdir(train):
        raise FileNotFoundError(
            f"{train} missing; combined custom layouts need train/ and test/ "
            f"(use --train-only/--eval-only for split-less roots).")
    classes = sorted(d for d in os.listdir(train) if pt.isdir(pt.join(train, d)))
    ovr = not any(
        pt.isdir(pt.join(train, c, sub))
        for c in classes for sub in ("normal", "nominal"))
    check_custom_layout(dest, ovr=ovr)
    print(f"custom ({'one-vs-rest' if ovr else 'general'}) layout OK: "
          f"{len(classes)} classes {classes[:8]}{'...' if len(classes) > 8 else ''}")
    return dest


# --------------------------------------------------- check-only validators
# (datasets whose prepare step is archive placement get a layout re-check)


def check_cifar(root: str, args) -> str:
    ds = args.dataset
    sub, member, files = (("cifar10", "cifar-10-batches-py",
                           [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"])
                          if ds == "cifar10"
                          else ("cifar100", "cifar-100-python", ["train", "test"]))
    dest = pt.join(root, sub, member)
    missing = [f for f in files if not pt.isfile(pt.join(dest, f))]
    if missing:
        raise FileNotFoundError(f"{dest} lacks {missing}")
    print(f"{ds} OK at {dest}")
    return dest


def check_idx(root: str, args) -> str:
    ds = args.dataset
    dest = pt.join(root, ds)
    prefix = "emnist-letters-" if ds == "emnist" else ""
    stems = [f"{prefix}train-images-idx3-ubyte", f"{prefix}train-labels-idx1-ubyte",
             f"{prefix}t10k-images-idx3-ubyte", f"{prefix}t10k-labels-idx1-ubyte"]
    missing = [s for s in stems
               if not any(pt.isfile(pt.join(dest, s + suf)) for suf in ("", ".gz"))]
    if missing:
        raise FileNotFoundError(f"{dest} lacks idx files {missing}")
    print(f"{ds} OK at {dest}")
    return dest


def check_mvtec(root: str, args) -> str:
    from eoe_tpu_torch.datasets.mvtec import LABELS, _blob_path
    dest = pt.join(root, "mvtec")
    if args.blob_resolution:
        bp = _blob_path(dest, (args.blob_resolution, args.blob_resolution))
        if not pt.isfile(bp):
            raise FileNotFoundError(f"blob {bp} missing (run without --check-only "
                                    f"to build it)")
        print(f"mvtec blob OK at {bp}")
        return bp
    present = [c for c in LABELS if pt.isdir(pt.join(dest, c, "train", "good"))]
    if len(present) < len(LABELS):
        raise FileNotFoundError(
            f"mvtec at {dest}: only {len(present)}/{len(LABELS)} classes have "
            f"train/good (missing: {sorted(set(LABELS) - set(present))[:5]})")
    print(f"mvtec OK: {len(present)} classes at {dest}")
    return dest


def check_cub_only(root: str, args) -> str:
    dest = pt.join(root, "cub")
    return _check_cub_tree(dest)


def check_dtd(root: str, args) -> str:
    out = pt.join(root, "dtd", "dtd")
    for req in ("images", "labels"):
        if not pt.isdir(pt.join(out, req)):
            raise FileNotFoundError(f"{out}/{req} missing")
    print(f"dtd OK at {out}")
    return out


def check_tinyimages(root: str, args) -> str:
    out = pt.join(root, "tinyimages", "tiny_images.bin")
    if not pt.isfile(out):
        raise FileNotFoundError(f"{out} missing")
    size = pt.getsize(out)
    if size != TINYIMAGES_BYTES and not args.skip_hash:
        raise ValueError(f"{out} is {size} bytes, expected {TINYIMAGES_BYTES}")
    print(f"tinyimages OK ({size} bytes)")
    return out


def check_clip(root: str, args) -> str:
    dest = pt.join(pt.dirname(root), "clip_checkpoints") if root.endswith("datasets") \
        else pt.join(root, "clip_checkpoints")
    found = [f for f in (os.listdir(dest) if pt.isdir(dest) else [])
             if f.endswith(".pt")]
    if not found:
        raise FileNotFoundError(f"no .pt checkpoints under {dest}")
    for f in found:
        dig = CLIP_SHA256.get(f)
        verify_file(pt.join(dest, f), "sha256", dig, args.skip_hash)
    print(f"clip OK: {sorted(found)} at {dest}")
    return dest


HANDLERS = {
    "cifar10": prepare_cifar, "cifar100": prepare_cifar,
    "mnist": prepare_idx, "fmnist": prepare_idx, "emnist": prepare_idx,
    "mvtec": prepare_mvtec, "cub": prepare_cub, "dtd": prepare_dtd,
    "tinyimages": prepare_tinyimages, "clip": prepare_clip,
    "imagenet30": prepare_imagenet30, "imagenet21k": prepare_imagenet21k,
    "imagenet21ksubset": prepare_imagenet21ksubset, "custom": prepare_custom,
}

CHECKERS = {
    "cifar10": check_cifar, "cifar100": check_cifar,
    "mnist": check_idx, "fmnist": check_idx, "emnist": check_idx,
    "mvtec": check_mvtec, "cub": check_cub_only, "dtd": check_dtd,
    "tinyimages": check_tinyimages, "clip": check_clip,
    "imagenet30": check_imagenet30, "imagenet21k": check_imagenet21k,
    "imagenet21ksubset": check_imagenet21ksubset, "custom": check_custom,
}


def default_datapath() -> str:
    from eoe_tpu_torch.main import default_datapath as dp
    return dp()


def check_all(root: str, args) -> str:
    """`prepare_data all --check-only` (RUNBOOK §0): validate every dataset
    layout present on disk. Absent datasets (checkers raise
    FileNotFoundError) are reported and skipped; malformed layouts raise."""
    import copy
    checked, skipped = [], []
    for ds, checker in sorted(CHECKERS.items()):
        a = copy.copy(args)
        a.dataset = ds  # check_cifar/check_idx key their layout off this
        try:
            checker(root, a)
        except FileNotFoundError:
            skipped.append(ds)
            continue
        checked.append(ds)
    print(f"checked: {checked}\nabsent:  {skipped}")
    if not checked:
        raise FileNotFoundError(f"no prepared datasets found under {root}")
    return root


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", choices=sorted(HANDLERS) + ["all"],
                   help="dataset to prepare; 'all' (with --check-only) "
                        "validates every prepared layout (RUNBOOK §0)")
    p.add_argument("archives", nargs="*", help="user-provided archive file(s)")
    p.add_argument("--datapath", type=str, default=None,
                   help="data root (default: the runners' default datapath); "
                        "raw layouts land in <datapath>/datasets/<ds>/")
    p.add_argument("--skip-hash", action="store_true",
                   help="skip digest/size verification (use for self-built or "
                        "re-packaged archives)")
    p.add_argument("--blob-resolution", type=int, default=None,
                   help="mvtec: build (or with --check-only, require) the "
                        "admvtec_{r}x{r}.npz blob")
    p.add_argument("--check-only", action="store_true",
                   help="validate the existing on-disk layout only; no "
                        "extraction or placement")
    p.add_argument("--build-subset", type=int, default=None, metavar="N",
                   help="imagenet21ksubset: build the subset (N images/class) "
                        "from the prepared imagenet21k tree")
    p.add_argument("--subset-size", type=int, default=256,
                   help="imagenet21ksubset --build-subset: resize resolution")
    p.add_argument("--custom-root", type=str, default=None,
                   help="custom: dataset root to validate (default "
                        "<datapath>/datasets/custom)")
    p.add_argument("--train-only", action="store_true",
                   help="custom: validate a split-less training root "
                        "(normal/ folder)")
    p.add_argument("--eval-only", action="store_true",
                   help="custom: validate a split-less inference root")
    p.add_argument("--download", action="store_true",
                   help="fetch the dataset's published archives (the "
                        "reference's own endpoints: torchvision URLs, MVTec "
                        "tar.xz w/ https->http retry, OpenAI CLIP ViT-B/32) "
                        "instead of supplying them; digests are still "
                        "verified. Skips cleanly when there is no egress.")
    p.add_argument("--download-dir", type=str, default=None,
                   help="where downloaded archives land "
                        "(default <datapath>/downloads)")
    args = p.parse_args(argv)

    datapath = args.datapath or default_datapath()
    root = pt.join(datapath, "datasets")
    if args.check_only:
        if args.archives:
            p.error("--check-only takes no archives")
        out = (check_all if args.dataset == "all"
               else CHECKERS[args.dataset])(root, args)
        print(f"{args.dataset} layout OK at {out}")
        return out
    if args.dataset == "all":
        p.error("'all' only works with --check-only")
    if args.download:
        if args.archives:
            p.error("--download and explicit archives are mutually exclusive")
        fetched = download_archives(
            args.dataset, args.download_dir or pt.join(datapath, "downloads"))
        if fetched is None:
            return None  # clean skip: no egress / no endpoint
        args.archives = fetched
    if not args.archives and args.dataset not in ("imagenet21ksubset", "custom"):
        p.error("archives required (or pass --check-only / --download)")
    for a in args.archives:
        if not pt.isfile(a):
            raise FileNotFoundError(a)
    out = HANDLERS[args.dataset](args.dataset, args.archives, root, args)
    print(f"{args.dataset} ready at {out}")
    return out


if __name__ == "__main__":
    main()
