"""The port's offline data-prep and integrity CLI
(eoe_tpu_torch.main.prepare_data) against the JAX package's: the cases of
tests/test_prepare_data.py, each call made by both packages' ``main`` with
the same archives and arguments, each into its own data root. Their
outcomes (the returned path or the error raised), their printed lines and
the trees they leave (paths and bytes; a .npz by its arrays) must be equal,
paths read relative to each package's root. The digest, size and URL tables
are held equal too. ``--download`` runs with ``fetch_url`` monkeypatched in
both modules: nothing is fetched."""

import gzip
import hashlib
import io
import os
import os.path as pt
import pickle
import shutil
import tarfile

import numpy as np
import pytest
from PIL import Image

import eoe_tpu.main.prepare_data as jax_pd
import eoe_tpu_torch.main.prepare_data as port_pd

PACKAGES = (("port", port_pd), ("jax", jax_pd))


def _tar_from_tree(tree: dict, out_path: str, mode: str = "w:gz"):
    """tree: {relative/path: bytes} -> tar archive. A .tar.gz gets a zero
    gzip time stamp, so that two archives of one tree are the same bytes."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w" if mode == "w:gz" else mode) as t:
        for rel, data in tree.items():
            info = tarfile.TarInfo(rel)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    with open(out_path, "wb") as f:
        if mode == "w:gz":
            with gzip.GzipFile(filename="", mode="wb", fileobj=f, mtime=0) as g:
                g.write(buf.getvalue())
        else:
            f.write(buf.getvalue())
    return out_path


def _png_bytes(hw=16, seed=0) -> bytes:
    img = Image.fromarray(
        np.random.default_rng(seed).integers(0, 255, (hw, hw, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _tree(root: str) -> dict:
    """{relative path: bytes} of every file under root; a .npz by its arrays
    (its zip entries carry write times)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = pt.join(dirpath, f)
            rel = pt.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path, allow_pickle=False) as d:
                    out[rel] = {k: d[k] for k in d.files}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def _assert_trees_equal(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for rel, want in theirs.items():
        got = ours[rel]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), rel
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel}:{k}")
        else:
            assert got == want, rel


class Both:
    """Runs one prepare_data call in both packages, each under its own root
    (``tmp_path/port``, ``tmp_path/jax``), and holds the two runs equal.
    ``argv`` may hold ``{root}``, filled with the package's root."""

    def __init__(self, tmp_path, capsys):
        self.roots = {name: str(tmp_path / name) for name, _ in PACKAGES}
        self.capsys = capsys
        for r in self.roots.values():
            os.makedirs(r, exist_ok=True)

    def _norm(self, name, text):
        return str(text).replace(self.roots[name], "<root>")

    def __call__(self, *argv):
        results = {}
        for name, mod in PACKAGES:
            args = [a.format(root=self.roots[name]) for a in argv]
            self.capsys.readouterr()
            try:
                out = mod.main(args)
                outcome = ("ok", self._norm(name, out) if out is not None else None)
            except Exception as e:  # noqa: BLE001 - both packages' errors are compared
                outcome = ("err", type(e).__name__, self._norm(name, e))
            printed = self._norm(name, self.capsys.readouterr().out)
            results[name] = (outcome, printed, _tree(self.roots[name]))
        (o_p, s_p, t_p), (o_j, s_j, t_j) = results["port"], results["jax"]
        assert o_p == o_j
        assert s_p == s_j
        _assert_trees_equal(t_p, t_j)
        self.printed = s_p
        return o_p

    def ok(self, *argv):
        outcome = self(*argv)
        assert outcome[0] == "ok", outcome
        return outcome[1]

    def raises(self, exc, match, *argv):
        outcome = self(*argv)
        assert outcome[:2] == ("err", exc.__name__), outcome
        assert match in outcome[2], outcome
        return outcome[2]

    def in_root(self, name, rel):
        return pt.join(self.roots[name], rel)


@pytest.fixture
def both(tmp_path, capsys):
    return Both(tmp_path, capsys)


# ------------------------------------------------------------------ tables


def test_tables_equal_jax():
    """The digest tables, Tiny Images' size and the download endpoints are
    the JAX module's, entry for entry; so are the dataset names handled."""
    for name in ("CLIP_SHA256", "ARCHIVE_MD5", "DS_ARCHIVE_MD5",
                 "TINYIMAGES_BYTES", "DOWNLOAD_URLS"):
        assert getattr(port_pd, name) == getattr(jax_pd, name), name
    assert sorted(port_pd.HANDLERS) == sorted(jax_pd.HANDLERS)
    assert sorted(port_pd.CHECKERS) == sorted(jax_pd.CHECKERS)
    assert port_pd.CLIP_SHA256["ViT-B-32.pt"].startswith("40d365")


# --------------------------------------------------------------- digests


def test_verify_file_pass_and_fail(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"payload")
    good = hashlib.md5(b"payload").hexdigest()
    sha = hashlib.sha256(b"payload").hexdigest()
    for _, mod in PACKAGES:
        assert mod.file_digest(str(f), "md5") == good
        assert mod.file_digest(str(f), "sha256") == sha
        mod.verify_file(str(f), "md5", good)  # passes
        mod.verify_file(str(f), "md5", None)  # unknown digest: silently passes
        mod.verify_file(str(f), "md5", "0" * 32, skip=True)  # explicit skip
        with pytest.raises(ValueError) as e:
            mod.verify_file(str(f), "md5", "0" * 32)
        mod.verify_file(str(f), "sha256", sha)
        assert "md5 mismatch" in str(e.value)
    errs = []
    for _, mod in PACKAGES:
        try:
            mod.verify_file(str(f), "sha256", "1" * 64)
        except ValueError as e:
            errs.append(str(e))
    assert len(errs) == 2 and errs[0] == errs[1]


# ----------------------------------------------------------------- cifar


def _cifar_batch(n, labels_key=b"labels"):
    return pickle.dumps({
        b"data": np.zeros((n, 3072), np.uint8),
        labels_key: list(np.zeros(n, np.int64))})


def _fake_cifar10_archive(path):
    tree = {f"cifar-10-batches-py/data_batch_{i}": _cifar_batch(4)
            for i in range(1, 6)}
    tree["cifar-10-batches-py/test_batch"] = _cifar_batch(4)
    return _tar_from_tree(tree, path)


def test_prepare_cifar10_extracts_loadable_layout(tmp_path, both):
    from eoe_tpu_torch.datasets.cifar import load_cifar10

    arch = _fake_cifar10_archive(str(tmp_path / "cifar-10-python.tar.gz"))
    out = both.ok("cifar10", arch, "--datapath", "{root}", "--skip-hash")
    assert out == "<root>/datasets/cifar10/cifar-10-batches-py"
    xtr, ytr, xte, yte = load_cifar10(both.in_root("port", "datasets/cifar10"))
    assert xtr.shape == (20, 32, 32, 3) and xte.shape == (4, 32, 32, 3)
    # the real archive must hash-verify: a corrupt one raises
    both.raises(ValueError, "md5 mismatch",
                "cifar10", arch, "--datapath", "{root}")


# --------------------------------------------------------------- download


def _patch_fetch(monkeypatch, fetch):
    for _, mod in PACKAGES:
        monkeypatch.setattr(mod, "fetch_url", fetch)


def test_download_then_check_only_roundtrip(both, monkeypatch):
    """--download (mocked fetch, reference endpoints mvtec.py:323-333 /
    clip.py:36-53) -> placed layout -> --check-only passes. The fetched
    archive is digest-verified like a user-supplied one, so the fake archive
    must pair with --skip-hash."""
    fetched_urls = []

    def fake_fetch(url, dest, timeout=30.0):
        fetched_urls.append(url)
        os.makedirs(pt.dirname(dest), exist_ok=True)
        _fake_cifar10_archive(dest)
        return dest

    _patch_fetch(monkeypatch, fake_fetch)
    out = both.ok("cifar10", "--download", "--datapath", "{root}", "--skip-hash")
    assert out == "<root>/datasets/cifar10/cifar-10-batches-py"
    assert fetched_urls == [port_pd.DOWNLOAD_URLS["cifar10"][0]] * 2
    # downloaded file landed in the default download dir
    assert pt.isfile(both.in_root("port", "downloads/cifar-10-python.tar.gz"))
    # the placed layout passes --check-only
    assert both.ok("cifar10", "--check-only", "--datapath", "{root}")


def test_download_skips_cleanly_without_egress(both, monkeypatch):
    """No egress (the fetch raises) must be a clean skip: message, no
    traceback, None return."""
    def no_egress(url, dest, timeout=30.0):
        raise OSError("Network is unreachable")

    _patch_fetch(monkeypatch, no_egress)
    assert both.ok("cifar10", "--download", "--datapath", "{root}") is None
    assert "download failed" in both.printed
    # datasets with no public endpoint skip with a message too
    assert both.ok("imagenet30", "--download", "--datapath", "{root}") is None
    assert "no public download endpoint" in both.printed


def test_download_reuses_verified_archive(both, monkeypatch):
    """A previously-downloaded archive with a matching digest is not
    re-fetched."""
    digests = set()
    for name, _ in PACKAGES:
        dl = both.in_root(name, "downloads")
        os.makedirs(dl)
        arch = _fake_cifar10_archive(pt.join(dl, "cifar-10-python.tar.gz"))
        digests.add(port_pd.file_digest(arch, "md5"))
    (digest,) = digests  # gzip of the same members: the same bytes
    for _, mod in PACKAGES:
        monkeypatch.setitem(mod.ARCHIVE_MD5, "cifar-10-python.tar.gz", digest)

    def must_not_fetch(url, dest, timeout=30.0):
        raise AssertionError("should not re-fetch a verified archive")

    _patch_fetch(monkeypatch, must_not_fetch)
    assert both.ok("cifar10", "--download", "--datapath", "{root}") \
        == "<root>/datasets/cifar10/cifar-10-batches-py"
    assert "already downloaded" in both.printed


# ----------------------------------------------------------------- mvtec


def test_prepare_mvtec_builds_blob(tmp_path, both):
    tree = {}
    for cls in ("bottle", "wood"):
        for i in range(2):
            tree[f"{cls}/train/good/{i:03}.png"] = _png_bytes(seed=i)
            tree[f"{cls}/test/good/{i:03}.png"] = _png_bytes(seed=10 + i)
            tree[f"{cls}/test/broken/{i:03}.png"] = _png_bytes(seed=20 + i)
    arch = _tar_from_tree(tree, str(tmp_path / "mvtec_anomaly_detection.tar.xz"),
                          mode="w:xz")
    both.ok("mvtec", arch, "--datapath", "{root}", "--blob-resolution", "32")
    d = np.load(both.in_root("port", "datasets/mvtec/admvtec_32x32.npz"),
                allow_pickle=False)
    assert d["train_data"].shape == (4, 32, 32, 3)
    assert d["test_data"].shape == (8, 32, 32, 3)
    assert set(d["test_anomaly_labels"]) == {0, 1, 2}  # good + 2 class defects


def test_mvtec_blob_equals_jax(tmp_path, both):
    """Both packages unpack and convert the same MVTec archive, ground-truth
    masks included: the trees and the blobs' arrays (images, labels, anomaly
    labels) are equal, key for key; so are the blob checks after it."""
    tree = {}
    for cls in ("bottle", "wood"):
        for i in range(3):
            tree[f"{cls}/train/good/{i:03}.png"] = _png_bytes(hw=20, seed=i)
            tree[f"{cls}/test/good/{i:03}.png"] = _png_bytes(hw=20, seed=10 + i)
            tree[f"{cls}/test/broken/{i:03}.png"] = _png_bytes(hw=20, seed=20 + i)
            tree[f"{cls}/ground_truth/broken/{i:03}_mask.png"] = _png_bytes(hw=20, seed=30 + i)
    arch = _tar_from_tree(tree, str(tmp_path / "mvtec_anomaly_detection.tar.xz"), mode="w:xz")
    both.ok("mvtec", arch, "--datapath", "{root}", "--blob-resolution", "24")
    d = np.load(both.in_root("port", "datasets/mvtec/admvtec_24x24.npz"),
                allow_pickle=False)
    assert d["train_data"].shape == (6, 24, 24, 3)
    both.ok("mvtec", "--check-only", "--datapath", "{root}", "--blob-resolution", "24")
    both.raises(FileNotFoundError, "missing", "mvtec", "--check-only",
                "--datapath", "{root}", "--blob-resolution", "16")


# ------------------------------------------------------------------- cub


def test_prepare_cub_integrity_sweep(tmp_path, both):
    imgs = {"001.Black_footed_Albatross/a.jpg", "002.Laysan_Albatross/b.jpg"}
    tree = {f"CUB_200_2011/images/{rel}": _png_bytes() for rel in imgs}
    tree["CUB_200_2011/images.txt"] = "".join(
        f"{i + 1} {rel}\n" for i, rel in enumerate(sorted(imgs))).encode()
    arch = _tar_from_tree(tree, str(tmp_path / "CUB_200_2011.tgz"))
    out = both.ok("cub", arch, "--datapath", "{root}", "--skip-hash")
    assert pt.exists(pt.join(out.replace("<root>", both.roots["port"]),
                             "images.txt"))

    # corrupt: images.txt lists a file the archive lacks -> hard failure
    # (cub.py:203-210 role)
    tree.pop("CUB_200_2011/images/001.Black_footed_Albatross/a.jpg")
    arch2 = _tar_from_tree(tree, str(tmp_path / "CUB_bad.tgz"))
    both.raises(FileNotFoundError, "corrupted",
                "cub", arch2, "--datapath", "{root}/dp2", "--skip-hash")


# ------------------------------------------------------------------ clip


def test_prepare_clip_sha256(tmp_path, both):
    ck = tmp_path / "ViT-B-32.pt"
    ck.write_bytes(b"not the real checkpoint")
    both.raises(ValueError, "sha256 mismatch",
                "clip", str(ck), "--datapath", "{root}")
    # unknown checkpoint names are refused unless forced
    other = tmp_path / "mystery.pt"
    other.write_bytes(b"x")
    both.raises(ValueError, "unknown CLIP checkpoint",
                "clip", str(other), "--datapath", "{root}")
    out = both.ok("clip", str(ck), "--datapath", "{root}", "--skip-hash")
    assert pt.exists(out.replace("<root>", both.roots["port"]))
    assert "EOE_TPU_CLIP_CHECKPOINT" in both.printed


# ----------------------------------------------------------------- mnist


def test_prepare_mnist_places_gz(tmp_path, both):
    src = tmp_path / "train-images-idx3-ubyte.gz"
    with gzip.open(src, "wb") as f:
        f.write(b"\x00" * 16)
    both.raises(ValueError, "md5 mismatch",
                "mnist", str(src), "--datapath", "{root}")
    both.ok("mnist", str(src), "--datapath", "{root}", "--skip-hash")
    assert pt.exists(both.in_root("port", "datasets/mnist/train-images-idx3-ubyte.gz"))


# ------------------------------------------------------------ tinyimages


def test_prepare_tinyimages_size_gate(tmp_path, both):
    f = tmp_path / "tiny_images.bin"
    f.write_bytes(b"\x00" * 3072)
    both.raises(ValueError, "79302017",
                "tinyimages", str(f), "--datapath", "{root}")
    out = both.ok("tinyimages", str(f), "--datapath", "{root}", "--skip-hash")
    assert pt.exists(out.replace("<root>", both.roots["port"]))


# ------------------------------------------------- acceptance-config datasets


def _imagenet30_tree(root, n_img=2, splits=("train", "val")):
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    for split in splits:
        for c in AD_CLASSES:
            d = pt.join(root, "datasets", "imagenet_ad", split, c)
            os.makedirs(d, exist_ok=True)
            for i in range(n_img):
                with open(pt.join(d, f"{c}_{i}.png"), "wb") as f:
                    f.write(_png_bytes(seed=i))


def test_check_imagenet30_valid_and_missing_class(both):
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    for name, _ in PACKAGES:
        _imagenet30_tree(both.roots[name])
    out = both.ok("imagenet30", "--check-only", "--datapath", "{root}")
    assert out.endswith("imagenet_ad")
    # removing one AD class folder must fail with the class named
    for name, _ in PACKAGES:
        shutil.rmtree(both.in_root(name, f"datasets/imagenet_ad/val/{AD_CLASSES[3]}"))
    both.raises(FileNotFoundError, AD_CLASSES[3],
                "imagenet30", "--check-only", "--datapath", "{root}")


def test_prepare_imagenet30_from_archive(tmp_path, both):
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    tree = {}
    for split in ("train", "val"):
        for c in AD_CLASSES:
            tree[f"{split}/{c}/a.png"] = _png_bytes()
    arc = _tar_from_tree(tree, str(tmp_path / "in30.tar.gz"))
    out = both.ok("imagenet30", arc, "--datapath", "{root}/dp")
    assert pt.isdir(pt.join(out.replace("<root>", both.roots["port"]),
                            "train", AD_CLASSES[0]))


def _wnid_tree(root, wnids, n_img, seeded):
    base = pt.join(root, "datasets", "imagenet22k", "fall11_whole_extracted")
    for w in wnids:
        d = pt.join(base, w)
        os.makedirs(d)
        for i in range(n_img):
            name = f"{w}_{i}.png" if seeded else "img.png"
            with open(pt.join(d, name), "wb") as f:
                f.write(_png_bytes(seed=i))


def test_check_imagenet21k_counts_and_overlap(both):
    from eoe_tpu_torch.datasets.imagenet import IMAGENET1K_WNIDS
    wnids = ["n00000001", "n00000002", sorted(IMAGENET1K_WNIDS)[0]]
    for name, _ in PACKAGES:
        _wnid_tree(pt.join(both.roots[name], "dp"), wnids, 1, seeded=False)
    both.ok("imagenet21k", "--check-only", "--datapath", "{root}/dp")
    assert "3 wnid folders" in both.printed and "1 of the 30" in both.printed
    # empty tree fails
    both.raises(FileNotFoundError, "",
                "imagenet21k", "--check-only", "--datapath", "{root}/empty")


def test_build_imagenet21ksubset_from_tree(both):
    for name, _ in PACKAGES:
        _wnid_tree(pt.join(both.roots[name], "dp"), ("n00000001", "n00000002"),
                   4, seeded=True)
    out = both.ok("imagenet21ksubset", "--build-subset", "2",
                  "--subset-size", "32", "--datapath", "{root}/dp")
    files = sorted(os.listdir(pt.join(out.replace("<root>", both.roots["port"]),
                                      "n00000001")))
    assert len(files) == 2 and files[0].endswith(".jpg")
    # and the check-only pass now succeeds
    both.ok("imagenet21ksubset", "--check-only", "--datapath", "{root}/dp")


def _custom_tree(root, classes, subs):
    for split in ("train", "test"):
        for cls in classes:
            for sub in subs:
                d = pt.join(root, "datasets", "custom", split, cls, *sub)
                os.makedirs(d)
                with open(pt.join(d, "x.png"), "wb") as f:
                    f.write(_png_bytes())


def test_check_custom_layout_modes(both):
    # general layout: class folders with normal/anomalous
    for name, _ in PACKAGES:
        _custom_tree(pt.join(both.roots[name], "dp"), ("widget", "gadget"),
                     (("normal",), ("anomalous",)))
    out = both.ok("custom", "--check-only", "--datapath", "{root}/dp")
    assert out.endswith("custom")

    # one-vs-rest layout: plain class folders
    for name, _ in PACKAGES:
        _custom_tree(pt.join(both.roots[name], "dp2"), ("dog", "cat"), ((),))
    both.ok("custom", "--check-only", "--datapath", "{root}/dp2")

    # mismatched train/test classes fail
    for name, _ in PACKAGES:
        shutil.rmtree(both.in_root(name, "dp2/datasets/custom/test/cat"))
    both.raises(ValueError, "do not match",
                "custom", "--check-only", "--datapath", "{root}/dp2")


def test_check_custom_split_less_roots(tmp_path, both):
    root = tmp_path / "r"
    (root / "normal").mkdir(parents=True)
    both.ok("custom", "--check-only", "--train-only", "--custom-root", str(root),
            "--datapath", "{root}/dp")
    # eval-only with only an anomalous folder passes; bogus folder fails
    root2 = tmp_path / "r2"
    (root2 / "anomalous").mkdir(parents=True)
    both.ok("custom", "--check-only", "--eval-only", "--custom-root", str(root2),
            "--datapath", "{root}/dp")
    (root2 / "garbage").mkdir()
    both.raises(ValueError, "garbage",
                "custom", "--check-only", "--eval-only", "--custom-root",
                str(root2), "--datapath", "{root}/dp")


def test_check_only_existing_datasets(both):
    """--check-only for the archive-placed datasets validates the layout
    without archives (here: cifar10 golden path + failure)."""
    for name, _ in PACKAGES:
        dest = both.in_root(name, "dp/datasets/cifar10/cifar-10-batches-py")
        os.makedirs(dest)
        for f in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            with open(pt.join(dest, f), "wb") as fh:
                fh.write(pickle.dumps({"data": b""}))
    both.ok("cifar10", "--check-only", "--datapath", "{root}/dp")
    both.ok("all", "--check-only", "--datapath", "{root}/dp")
    for name, _ in PACKAGES:
        os.remove(both.in_root(name, "dp/datasets/cifar10/cifar-10-batches-py/test_batch"))
    both.raises(FileNotFoundError, "test_batch",
                "cifar10", "--check-only", "--datapath", "{root}/dp")
