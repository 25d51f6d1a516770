"""The port's folder sources (``eoe_tpu_torch.datasets.folder``), its native
batch decoder (``eoe_tpu_torch.native``) and the shared-memory codec
(``eoe_tpu_torch.utils.caching``) against the JAX package's, on small trees
of PNG and JPEG files written with PIL: scan order, blobs and their
sidecars byte for byte, uint8 gathers exactly (PIL path and native path),
the next-index substitution for a corrupt file, the RAM cache's
accounting, residency, and the cache server's blocks."""

import json
import os
import os.path as pt

import numpy as np
import pytest
from PIL import Image

import eoe_tpu.native as jax_native
from eoe_tpu.datasets import folder as JF
from eoe_tpu.utils import caching as JC
import eoe_tpu_torch.native as port_native
from eoe_tpu_torch.datasets import folder as F
from eoe_tpu_torch.utils import caching as C


def write_img(path, size, rng, gray=False):
    os.makedirs(pt.dirname(path), exist_ok=True)
    shape = size if gray else (*size, 3)
    arr = rng.integers(0, 256, shape, np.uint8)
    img = Image.fromarray(arr)
    if path.lower().endswith((".jpg", ".jpeg")):
        img.save(path, quality=90)
    else:
        img.save(path)
    return arr


def make_tree(root, rng):
    """Three classes, mixed formats, sizes around the raw shape, a nested
    folder, an upper-case extension and files that are not images."""
    sizes = [(24, 24), (16, 20), (32, 28), (12, 12)]
    for ci, cls in enumerate(("b_cls", "a_cls", "c_cls")):
        for i in range(4):
            ext = (".png", ".jpg", ".JPEG", ".png")[(i + ci) % 4]
            write_img(str(root / cls / f"img{i}{ext}"), sizes[(i + ci) % 4], rng,
                      gray=(i == 3 and ci == 1))
        (root / cls / "notes.txt").write_text("not an image")
    write_img(str(root / "a_cls" / "nested" / "deep.png"), (20, 20), rng)
    return str(root)


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    """Both packages' sources decode with PIL (``EOE_TPU_NATIVE=0``) or with
    their native batch decoders, built from a fresh start."""
    for mod in (jax_native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    if request.param == "pil":
        monkeypatch.setenv("EOE_TPU_NATIVE", "0")
        assert port_native.get_lib() is None and jax_native.get_lib() is None
    else:
        monkeypatch.delenv("EOE_TPU_NATIVE", raising=False)
        if port_native.get_lib() is None or jax_native.get_lib() is None:
            pytest.skip("the native decoder does not build here (g++, jpeglib.h or png.h "
                        "missing)")
    return request.param


def test_scan_order_equals_jax(tmp_path, rng):
    root = make_tree(tmp_path, rng)
    ours, theirs = F.scan_image_folder(root, use_cache=False), \
        JF.scan_image_folder(root, use_cache=False)
    assert ours[0] == theirs[0] and ours[2] == theirs[2] == ["a_cls", "b_cls", "c_cls"]
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert len(ours[0]) == 13 and ours[1].dtype == np.int64
    assert F.blob_path(root, (8, 16)) == JF.blob_path(root, (8, 16))
    assert F.IMG_EXTENSIONS == JF.IMG_EXTENSIONS
    # the scan cache answers a second scan without looking at the disk
    cached = F.scan_image_folder(root)
    (tmp_path / "a_cls" / "late.png").write_bytes(b"")
    assert F.scan_image_folder(root) is cached
    with pytest.raises(FileNotFoundError, match="image folder not found"):
        F.scan_image_folder(str(tmp_path / "missing"))


@pytest.mark.parametrize("raw_shape", [(16, 16, 3), (24, 20, 1)])
@pytest.mark.parametrize("cache_bytes", [0, 1 << 20])
def test_folder_gathers_equal_jax(tmp_path, rng, decoder, raw_shape, cache_bytes):
    """uint8 gathers equal the JAX package's exactly: batches with repeats,
    single indices, gather_all through a Subset, cached or not."""
    from eoe_tpu.datasets.bases import Subset as JSubset
    from eoe_tpu_torch.datasets.bases import Subset
    root = make_tree(tmp_path, rng)
    paths, targets, _ = F.scan_image_folder(root, use_cache=False)
    ours = F.FolderSource(paths, targets, raw_shape, cache_bytes=cache_bytes, workers=4)
    theirs = JF.FolderSource(paths, targets, raw_shape, cache_bytes=cache_bytes, workers=4)
    for idx in ([0, 5, 5, 12, 3], [7], list(range(13)), [12, 0]):
        got = ours.gather(np.asarray(idx))
        assert got.dtype == np.uint8 and got.shape == (len(idx), *raw_shape)
        np.testing.assert_array_equal(got, theirs.gather(np.asarray(idx)))
    sub = np.asarray([1, 4, 9])
    np.testing.assert_array_equal(Subset(ours, sub).gather_all(),
                                  JSubset(theirs, sub).gather_all())
    assert sorted(ours._cache) == sorted(theirs._cache)
    assert ours._cache_used == theirs._cache_used


def test_decode_image_equals_jax(tmp_path, rng):
    root = make_tree(tmp_path, rng)
    for p in F.scan_image_folder(root, use_cache=False)[0]:
        for hw, gray in (((16, 16), False), ((9, 13), True), ((32, 28), False)):
            got = F.decode_image(p, hw, gray)
            np.testing.assert_array_equal(got, JF.decode_image(p, hw, gray))
            assert got.shape == (*hw, 1 if gray else 3)


def test_native_decoder_equals_jax(tmp_path, rng, decoder):
    """The port's copy of loader.cpp decodes and resizes as the JAX package's
    library does, and reports a failed image in its status."""
    if decoder == "pil":
        assert port_native.decode_batch(["x"], (8, 8), 3) is None
        return
    root = make_tree(tmp_path, rng)
    paths = F.scan_image_folder(root, use_cache=False)[0]
    for hw, c in (((16, 16), 3), ((10, 14), 1), ((40, 40), 3)):
        got = port_native.decode_batch(paths, hw, c, n_threads=3)
        np.testing.assert_array_equal(got, jax_native.decode_batch(paths, hw, c, n_threads=3))
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"truncated")
    out, status = port_native.decode_batch_with_status([paths[0], bad], (8, 8), 3)
    assert status.tolist()[0] == 0 and status.tolist()[1] != 0
    assert port_native.decode_batch([paths[0], bad], (8, 8), 3) is None
    assert port_native.library_path().parent.name == "_build"


def test_corrupt_file_serves_the_next_index(tmp_path, rng, decoder):
    root = tmp_path / "tree"
    write_img(str(root / "a" / "0.png"), (8, 8), rng)
    (root / "a" / "1.png").write_bytes(b"not an image")
    write_img(str(root / "a" / "2.jpg"), (12, 12), rng)
    (root / "a" / "3.jpg").write_bytes(b"\xff\xd8\xff\xd9" + bytes(8))   # no image
    paths, targets, _ = F.scan_image_folder(str(root), use_cache=False)
    for cache in (0, 1 << 20):
        ours = F.FolderSource(paths, targets, (8, 8, 3), cache_bytes=cache)
        theirs = JF.FolderSource(paths, targets, (8, 8, 3), cache_bytes=cache)
        for idx in ([1], [3], [0, 1, 2, 3], [3, 3]):
            got = ours.gather(np.asarray(idx))
            np.testing.assert_array_equal(got, theirs.gather(np.asarray(idx)))
        # a failed image is decoded by PIL, which serves the next index in
        # its place: 1 -> 2, and 3 wraps around to 0
        np.testing.assert_array_equal(ours.gather(np.asarray([1]))[0],
                                      F.decode_image(paths[2], (8, 8)))
        np.testing.assert_array_equal(ours.gather(np.asarray([3]))[0],
                                      F.decode_image(paths[0], (8, 8)))


def test_ram_cache_accounting(tmp_path, rng, decoder):
    """The budget admits whole images only; later gathers come from RAM (the
    files may vanish); a budget of 0 keeps nothing; ``fits_resident`` and
    ``warm_cache`` follow the budget, as in the JAX package."""
    root = tmp_path / "tree"
    for i in range(6):
        write_img(str(root / "a" / f"{i}.png"), (10, 10), rng)
    paths, targets, _ = F.scan_image_folder(str(root), use_cache=False)
    one = 8 * 8 * 3
    ours = F.FolderSource(paths, targets, (8, 8, 3), cache_bytes=2 * one + 5)
    theirs = JF.FolderSource(paths, targets, (8, 8, 3), cache_bytes=2 * one + 5)
    first = ours.gather(np.asarray([4, 1, 4, 5]))
    np.testing.assert_array_equal(first, theirs.gather(np.asarray([4, 1, 4, 5])))
    # admitted in index order (the JAX package's PIL path admits in the
    # order its threads finish; its native path in index order)
    assert sorted(ours._cache) == [1, 4] and ours._cache_used == 2 * one
    if decoder == "native":
        assert sorted(theirs._cache) == [1, 4] and theirs._cache_used == 2 * one
    assert ours.fits_resident(2) and not ours.fits_resident(3)
    assert [ours.fits_resident(n) for n in range(5)] == [theirs.fits_resident(n)
                                                         for n in range(5)]
    for i in (1, 4):
        os.remove(paths[i])
    np.testing.assert_array_equal(ours.gather(np.asarray([4, 1])), first[[0, 1]])
    warm = F.FolderSource(paths, targets, (8, 8, 3), cache_bytes=3 * one)
    warm.warm_cache([0, 2, 3, 5])
    assert sorted(warm._cache) == [0, 2, 3] and warm._cache_used == 3 * one
    off = F.FolderSource(paths, targets, (8, 8, 3), cache_bytes=0)
    off.gather(np.asarray([0, 2]))
    off.gather(np.asarray([3]))
    assert not off._cache and not off.fits_resident(1) and not off.resident


def test_default_cache_budget_follows_the_class(tmp_path, rng, monkeypatch):
    write_img(str(tmp_path / "a" / "0.png"), (8, 8), rng)
    paths, targets, _ = F.scan_image_folder(str(tmp_path), use_cache=False)
    assert F.FolderSource.DEFAULT_CACHE_BYTES == JF.FolderSource.DEFAULT_CACHE_BYTES
    assert F.BlobSource.RESIDENT_BYTES == JF.BlobSource.RESIDENT_BYTES
    monkeypatch.setattr(F.FolderSource, "DEFAULT_CACHE_BYTES", 0)
    assert F.FolderSource(paths, targets, (8, 8, 3)).cache_bytes == 0


def test_blob_equals_jax(tmp_path, rng, decoder):
    """``build_blob`` writes the JAX package's .npy and sidecar byte for byte;
    ``load_blob_source`` serves them with the same targets, classes and
    gathers (grayscale by slicing channels), refuses another resolution and
    a sidecar that disagrees, and blobs are resident within their budget."""
    root = make_tree(tmp_path, rng)
    out = JF.build_blob(root, (12, 16), workers=3, batch=5)
    want = {ext: open(out + ext, "rb").read() for ext in ("", ".json")}
    os.remove(out)
    os.remove(out + ".json")
    assert F.build_blob(root, (12, 16), workers=3, batch=5) == out
    for ext in ("", ".json"):
        assert open(out + ext, "rb").read() == want[ext], ext
    for raw in ((12, 16, 3), (12, 16, 1)):
        src, targets, classes = F.load_blob_source(root, raw)
        jsrc, jtargets, jclasses = JF.load_blob_source(root, raw)
        assert isinstance(src, F.BlobSource) and classes == jclasses
        np.testing.assert_array_equal(targets, jtargets)
        assert src.paths == jsrc.paths and len(src) == 13 and src.raw_shape == raw
        for idx in ([0, 3, 3, 12], [5]):
            np.testing.assert_array_equal(src.gather(np.asarray(idx)),
                                          jsrc.gather(np.asarray(idx)))
        assert src.fits_resident(13) and not src.resident
        assert src.fits_resident(10 ** 9) == jsrc.fits_resident(10 ** 9)
    paths, ftargets, _ = F.scan_image_folder(root, use_cache=False)
    decoded = F.FolderSource(paths, ftargets, (12, 16, 3)).gather(np.arange(13))
    np.testing.assert_array_equal(F.load_blob_source(root, (12, 16, 3))[0].gather(
        np.arange(13)), decoded)
    assert F.load_blob_source(root, (8, 8, 3)) is None
    with open(out + ".json") as f:
        meta = json.load(f)
    meta["targets"] = meta["targets"][:-1]
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
    assert F.load_blob_source(root, (12, 16, 3)) is None
    (tmp_path / "empty" / "a").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no images"):
        F.build_blob(str(tmp_path / "empty"), (8, 8))


def test_shm_codec_and_server_blocks_equal_jax(tmp_path, rng):
    """The codec's bytes equal the JAX package's; a source with
    ``shm_prefix`` reads the server's blocks (resized when their size
    differs) before the disk, and the disk where a block is missing."""
    img = rng.integers(0, 256, (17, 23, 3), np.uint8)
    np.testing.assert_array_equal(C.encode_shape_and_image(img),
                                  JC.encode_shape_and_image(img))
    np.testing.assert_array_equal(C.decode_shape_and_image(C.encode_shape_and_image(img)), img)
    root = tmp_path / "tree"
    for i in range(3):
        write_img(str(root / "a" / f"{i}.png"), (8, 8), rng)
    paths, targets, _ = F.scan_image_folder(str(root), use_cache=False)
    prefix = f"eoe_port_test_{os.getpid()}"
    names = [f"{prefix}_{i}" for i in range(2)]
    try:
        assert C.write_shm_image(names[0], img[:8, :8]) == 15 + 8 * 8 * 3
        C.write_shm_image(names[1], img)   # another size: resized on read
        ours = F.FolderSource(paths, targets, (8, 8, 3), shm_prefix=prefix)
        theirs = JF.FolderSource(paths, targets, (8, 8, 3), shm_prefix=prefix)
        got = ours.gather(np.arange(3))
        np.testing.assert_array_equal(got, theirs.gather(np.arange(3)))
        np.testing.assert_array_equal(got[0], img[:8, :8])
        np.testing.assert_array_equal(got[2], F.decode_image(paths[2], (8, 8)))
        np.testing.assert_array_equal(C.read_shm_image(names[1]), img)
    finally:
        for n in names:
            assert C.unlink_shm_image(n)
    assert C.read_shm_image(names[0]) is None and not C.unlink_shm_image(names[0])
