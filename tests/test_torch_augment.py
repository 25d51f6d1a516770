"""The augmentation peepholes and the crop step of ``ops.augment`` against
the JAX package, on the CPU (where ``crop_augment`` runs its plain version).

Inputs are numpy arrays from a seed; the JAX draws are made from the JAX
keys as the JAX functions make them and injected into the port. Exact where
only gathers run, 1e-5 where float arithmetic does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops import preprocess as JP
from eoe_tpu_torch.ops import augment as A
from eoe_tpu_torch.ops import preprocess as P
from tests.test_torch_preprocess import _jax_draws


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _banded(n, h, w, c, dtype, seed, box):
    """Images of 0 with a random texture in ``box`` (rows, cols): crops that
    miss the box are constant, so the degenerate fallback takes them."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, h, w, c), np.uint8)
    (r0, r1), (c0, c1) = box
    x[:, r0:r1, c0:c1] = rng.integers(1, 256, (n, r1 - r0, c1 - c0, c), dtype=np.uint8)
    return x if dtype == "uint8" else x.astype(np.float32) / 255.0


def _near_white(n, seed, hw=32, centre=8):
    """Images of 254/255 pixels with a textured ``centre`` x ``centre``
    middle: the white JPEG border the degenerate guard exists for."""
    rng = np.random.default_rng(seed)
    x = rng.integers(254, 256, (n, hw, hw, 3), dtype=np.uint8)
    a = (hw - centre) // 2
    x[:, a:a + centre, a:a + centre] = rng.integers(0, 256, (n, centre, centre, 3),
                                                    dtype=np.uint8)
    return x


JITTER = {"brightness": 0.01, "contrast": 0.01, "saturation": 0.01, "hue": 0.01}
NEAR_WHITE = [{"op": "resize", "size": 32}, {"op": "color_jitter", **JITTER},
              {"op": "random_crop", "size": 9}, {"op": "random_hflip", "p": 0.5},
              {"op": "clip_pil_preprocessing", "resolution": 9},
              {"op": "gaussian_noise", "std": 0.001}, {"op": "clip_tensor_preprocessing"}]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_near_white_crops_match_jax_default_pipeline(seed, monkeypatch):
    """The JAX package's default fuses the jitter into the crop and tests the
    RAW crop for constancy; a near-white crop the brightness clip makes
    constant is kept there, where the unfused order falls back to the centre.
    The port follows whichever the JAX package compiles."""
    images = _near_white(16, seed)
    key = jax.random.key(seed)
    draws = _jax_draws(NEAR_WHITE, images.shape, key)
    ours = P.compile_pipeline(NEAR_WHITE, degenerate_crop_guard=True)(
        torch.from_numpy(images), draws=draws).numpy()
    ref = np.asarray(JP.compile_pipeline(NEAR_WHITE, degenerate_crop_guard=True)(
        jnp.asarray(images), key))
    np.testing.assert_allclose(ours, ref, atol=1e-5)

    monkeypatch.setenv("EOE_TPU_FUSE_JITTER_CROP", "0")
    unfused = np.asarray(JP.compile_pipeline(NEAR_WHITE, degenerate_crop_guard=True)(
        jnp.asarray(images), key))
    ours_unfused = P.compile_pipeline(NEAR_WHITE, degenerate_crop_guard=True)(
        torch.from_numpy(images), draws=draws).numpy()
    np.testing.assert_allclose(ours_unfused, unfused, atol=1e-5)
    # the two verdicts part on some images: the case the fusion changes
    differ = np.abs(ref - unfused).max(axis=(1, 2, 3)) > 0.1
    assert 1 <= differ.sum() < 16


def _jax_crop_flip_draws(key_crop, key_flip, shape, size, padding, p=0.5):
    n, h, w, _ = shape
    ki, kj = jax.random.split(key_crop)
    tops = jax.random.randint(ki, (n,), 0, h + 2 * padding - size[0] + 1)
    lefts = jax.random.randint(kj, (n,), 0, w + 2 * padding - size[1] + 1)
    flip = jax.random.bernoulli(key_flip, p, (n, 1, 1, 1))
    return _t(tops), _t(lefts), _t(flip).reshape(n)


@pytest.mark.parametrize("flip_first", [False, True])
@pytest.mark.parametrize("padding", [0, 2])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("guard", [False, True])
def test_random_crop_hflip_matches_jax(flip_first, padding, dtype, guard):
    """17 - 6 = 11 columns to spare: the flip-first fallback's mirrored
    centre window lies one column from the centre window."""
    images = _banded(24, 16, 17, 3, dtype, seed=3, box=((7, 9), (7, 10)))
    size = (5, 6)
    kc, kf = jax.random.split(jax.random.key(padding + 2 * flip_first))
    ref = np.asarray(JP.random_crop_hflip(jnp.asarray(images), kc, kf, size, padding=padding,
                                          resample_degenerate=guard, flip_first=flip_first))
    tops, lefts, flip = _jax_crop_flip_draws(kc, kf, images.shape, size, padding)
    ours = P.random_crop_hflip(torch.from_numpy(images), tops, lefts, flip, size, padding,
                               guard, flip_first).numpy()
    np.testing.assert_array_equal(ours, ref)
    if guard:   # some crops fell back, flipped and not
        plain = P.random_crop_hflip(torch.from_numpy(images), tops, lefts, flip, size, padding,
                                    False, flip_first).numpy()
        fell = (ours != plain).any(axis=(1, 2, 3))
        assert fell.any() and flip[torch.from_numpy(fell)].any()


def _jax_jitter_draws(key, n, color, **f):
    kb, kc, ks, kh = jax.random.split(key, 4)
    out = {}
    for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
        if f.get(name, 0) > 0 and (color or name != "saturation"):
            out[name] = _t(jax.random.uniform(k, (n, 1, 1, 1), minval=max(0.0, 1 - f[name]),
                                              maxval=1 + f[name]))
    if f.get("hue", 0) > 0 and color:
        out["hue"] = _t(jax.random.uniform(kh, (n, 1, 1), minval=-f["hue"], maxval=f["hue"]))
    return out


@pytest.mark.parametrize("factors", [JITTER, {"brightness": 0.4, "contrast": 0.4,
                                              "saturation": 0.4, "hue": 0.2},
                                     {"contrast": 0.5}])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("guard", [False, True])
def test_color_jitter_crop_flip_matches_jax(factors, dtype, flip, guard):
    white = _near_white(8, seed=4, hw=20, centre=6)
    images = np.concatenate([white, _banded(8, 20, 20, 3, "uint8", 5, ((8, 12), (8, 12)))])
    images = images if dtype == "uint8" else images.astype(np.float32) / 255.0
    size = (7, 7)
    kj, kc, kf = jax.random.split(jax.random.key(6), 3)
    ref = np.asarray(JP.color_jitter_crop_flip(
        jnp.asarray(images), kj, kc, kf if flip else None, size=size,
        resample_degenerate=guard, **factors))
    tops, lefts, bits = _jax_crop_flip_draws(kc, kf, images.shape, size, 0)
    jit = _jax_jitter_draws(kj, len(images), True, **factors)
    ours = P.color_jitter_crop_flip(torch.from_numpy(images), tops, lefts,
                                    bits if flip else None, size=size,
                                    resample_degenerate=guard, **jit).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _jax_peepholes(specs, shape, monkeypatch):
    """The peepholes the JAX package's ``compile_pipeline`` took, as (name,
    fused ops in order), from its functions wrapped while it compiles and
    runs once."""
    taken, depth = [], [0]

    def wrap(name, fn):
        def inner(*args, **kw):
            if depth[0] == 0:
                if name == "color_jitter_crop_flip":
                    flip = len(args) > 3 and args[3] is not None
                    taken.append((name, ["color_jitter", "random_crop"]
                                  + (["random_hflip"] if flip else [])))
                else:
                    order = ["random_hflip", "random_crop"] if kw.get("flip_first") else \
                        ["random_crop", "random_hflip"]
                    taken.append((name, order))
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return inner

    for name in ("color_jitter_crop_flip", "random_crop_hflip"):
        monkeypatch.setattr(JP, name, wrap(name, getattr(JP, name)))
    stats = JP.DatasetStats((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    JP.compile_pipeline(specs, stats)(jnp.zeros(shape, jnp.uint8), jax.random.key(0))
    return taken


def _port_peepholes(specs):
    stats = P.DatasetStats((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    return P.compile_pipeline(specs, stats).fused


ACCEPTANCE = [{"op": "resize", "size": 40}, {"op": "color_jitter", **JITTER},
              {"op": "random_crop", "size": 32, "resample_degenerate": True},
              {"op": "random_hflip", "p": 0.5},
              {"op": "clip_pil_preprocessing", "resolution": 32},
              {"op": "gaussian_noise", "std": 0.001}, {"op": "clip_tensor_preprocessing"}]
WRN = [{"op": "resize", "size": 40}, {"op": "random_hflip", "p": 0.5},
       {"op": "random_crop", "size": 32, "resample_degenerate": True}, "normalize"]
CIFAR = [{"op": "color_jitter", **JITTER}, {"op": "random_hflip", "p": 0.5},
         {"op": "random_crop", "size": 32, "padding": 4},
         {"op": "gaussian_noise", "std": 0.001}, "normalize"]
CLIP_CIFAR = [{"op": "resize", "size": 32}, {"op": "color_jitter", **JITTER},
              {"op": "random_crop", "size": 32, "padding": 4}, {"op": "random_hflip", "p": 0.5},
              {"op": "clip_pil_preprocessing", "resolution": 64},
              {"op": "gaussian_noise", "std": 0.001}, {"op": "clip_tensor_preprocessing"}]
JITTER_CROP = [{"op": "color_jitter", **JITTER}, {"op": "random_crop", "size": 32}, "normalize"]
CROP_ALONE = [{"op": "random_crop", "size": 32}, "gcn-normalize"]


CLIP_TAIL = ["clip_pil_preprocessing", "gaussian_noise", "clip_tensor_preprocessing"]


@pytest.mark.parametrize("specs,fuse,expected", [
    (ACCEPTANCE, "1", [("color_jitter_crop_flip", CLIP_TAIL)]),
    (ACCEPTANCE, "0", [("random_crop_hflip", CLIP_TAIL)]),
    (WRN, "1", [("random_crop_hflip", ["normalize"])]),
    (CIFAR, "1", [("random_crop_hflip", ["gaussian_noise", "normalize"])]),
    (CLIP_CIFAR, "1", [("random_crop_hflip", [])]),      # a padded crop keeps the jitter apart
    (JITTER_CROP, "1", [("color_jitter_crop_flip", ["normalize"])]),
    (JITTER_CROP, "0", [("random_crop", ["normalize"])]),
    (CROP_ALONE, "1", [("random_crop", [])])],
    ids=["acceptance", "acceptance-unfused", "wrn", "cifar", "clip-cifar", "jitter-crop",
         "jitter-crop-unfused", "crop-alone"])
def test_peepholes_are_the_jax_packages(specs, fuse, expected, monkeypatch):
    monkeypatch.setenv("EOE_TPU_FUSE_JITTER_CROP", fuse)
    ours = _port_peepholes(specs)
    assert [(name, folded) for name, _, folded in ours] == expected
    jax_taken = _jax_peepholes(specs, (2, 40, 40, 3), monkeypatch)
    assert [(name, parts) for name, parts, _ in ours if name != "random_crop"] == jax_taken


def _unfused_draws(g, x, specs):
    """The draws of ``specs`` made op by op, as unfused steps make them: each
    random op on the shape and dtype of its input."""
    n, h, w, c = x.shape
    dt = x.dtype
    out = []
    for s in specs:
        s = {"op": s} if isinstance(s, str) else s
        op = s["op"]
        if op == "color_jitter":
            dt = torch.float32
            out.append(P.draw_color_jitter(P._rows(n, (h, w, c), dt, "cpu"), g,
                                           **{k: s[k] for k in JITTER}))
        elif op == "random_crop":
            out.append(P.draw_random_crop(P._rows(n, (h, w, c), dt, "cpu"), g,
                                          size=(s["size"],) * 2, padding=s.get("padding", 0)))
            h = w = s["size"]
        elif op == "random_hflip":
            out.append(P.draw_random_hflip(P._rows(n, (h, w, c), dt, "cpu"), g, p=s["p"]))
        elif op == "gaussian_noise":
            out.append(P.draw_gaussian_noise(P._rows(n, (h, w, c), torch.float32, "cpu"), g))
        elif op in ("resize", "clip_pil_preprocessing"):
            h = w = s.get("size", s.get("resolution"))
    return out


@pytest.mark.parametrize("specs", [ACCEPTANCE, WRN, CIFAR, CLIP_CIFAR],
                         ids=["acceptance", "wrn", "cifar", "clip-cifar"])
def test_fused_steps_draw_as_unfused(specs, monkeypatch):
    """One generator seed: the fused pipeline's draws, the unfused one's
    (EOE_TPU_FUSE_JITTER_CROP=0) and the draws made op by op are equal
    tensors in the same order, and applying leaves the generator where
    drawing does."""
    stats = P.DatasetStats((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    x = torch.from_numpy(_banded(3, 40, 40, 3, "uint8", 7, ((10, 30), (10, 30))))
    x = x[:, :32, :32] if specs is CIFAR or specs is CLIP_CIFAR else x
    fused = P.compile_pipeline(specs, stats)
    monkeypatch.setenv("EOE_TPU_FUSE_JITTER_CROP", "0")
    unfused = P.compile_pipeline(specs, stats)
    runs = [f.draw(x.contiguous(), generator=torch.Generator().manual_seed(5))
            for f in (fused, unfused)]
    runs.append(_unfused_draws(torch.Generator().manual_seed(5), x, specs))
    assert fused.random_ops == unfused.random_ops
    for run in runs[1:]:
        assert len(run) == len(runs[0])
        for a, b in zip(runs[0], run):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    fused(x.contiguous(), generator=g1)
    fused.draw(x.contiguous(), generator=g2)
    assert torch.equal(g1.get_state(), g2.get_state())


def _step_by_step(specs, images, draws, stats, core):
    """The first ``core`` specs as one pipeline, then each later spec as a
    pipeline of its own, each taking its share of ``draws``."""
    x, k = images, 0
    for part in [specs[:core]] + [[s] for s in specs[core:]]:
        f = P.compile_pipeline(part, stats)
        n = len(f.random_ops)
        x = f(x, draws=draws[k:k + n])
        k += n
    return x


@pytest.mark.parametrize("specs,core,raw", [(ACCEPTANCE, 4, 40), (WRN, 3, 40), (CIFAR, 3, 32)],
                         ids=["acceptance", "wrn", "cifar"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_epilogue_fold_is_the_steps_one_by_one(specs, core, raw, dtype):
    stats = P.DatasetStats((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    images = torch.from_numpy(_banded(6, raw, raw, 3, dtype, 8, ((4, raw - 4), (6, raw - 2))))
    images[0] = images[0, 0, 0]   # constant: the guard's fallback
    f = P.compile_pipeline(specs, stats)
    assert f.fused[0][2] == [s if isinstance(s, str) else s["op"] for s in specs[core:]]
    draws = f.draw(images, generator=torch.Generator().manual_seed(9))
    ours = f(images, draws=draws)
    np.testing.assert_allclose(ours.numpy(), _step_by_step(specs, images, draws, stats,
                                                           core).numpy(), atol=1e-6)


@pytest.mark.parametrize("tail,folded,channels", [
    (["normalize", {"op": "gaussian_noise", "std": 0.1}], ["normalize"], 3),
    (["gcn-normalize"], [], 3),
    ([{"op": "clip_pil_preprocessing", "resolution": 16}], [], 3),
    ([{"op": "resize", "size": 8}, "to_tensor", {"op": "clip_pil_preprocessing",
                                                 "resolution": 8}, "normalize",
      {"op": "resize", "size": 8}], ["resize", "clip_pil_preprocessing", "normalize", "resize"], 3),
    ([{"op": "gaussian_noise", "std": 0.1}, {"op": "clip_pil_preprocessing", "resolution": 8}],
     ["gaussian_noise"], 3),
    ([{"op": "clip_pil_preprocessing", "resolution": 8}, {"op": "gaussian_noise", "std": 0.1},
      "normalize"], ["clip_pil_preprocessing", "gaussian_noise", "normalize"], 1),
    ([{"op": "gaussian_noise", "std": 0.1}, {"op": "clip_pil_preprocessing", "resolution": 8},
      "normalize"], ["gaussian_noise"], 1)])
def test_fold_ends_where_the_kernel_order_does(tail, folded, channels):
    """Folded: identity resizes anywhere, an identity clip_pil before the
    noise, one noise, one normalisation; a one-channel crop expands to three
    where clip_pil folds. Anything else ends the fold and runs as its own
    step, with the same result."""
    stats = P.DatasetStats((0.5, 0.4, 0.3), (0.25, 0.2, 0.3))
    specs = [{"op": "random_crop", "size": 8, "resample_degenerate": True}] + tail
    f = P.compile_pipeline(specs, stats)
    assert f.fused[0][2] == folded
    images = torch.from_numpy(_banded(4, 12, 12, channels, "uint8", 10, ((2, 10), (3, 9))))
    draws = f.draw(images, generator=torch.Generator().manual_seed(11))
    ours = f(images, draws=draws)
    assert ours.shape[0] == 4 and ours.shape[-1] == 3
    np.testing.assert_allclose(ours.numpy(),
                               _step_by_step(specs, images, draws, stats, 1).numpy(), atol=1e-6)


def _zero_source_window(x, tops, lefts, flip, flip_first, size, padding, b):
    """Zero image ``b`` where its crop comes from: flip -> crop takes a
    flipped image's crop from the mirrored window."""
    raw = x.shape[2]
    left = int(lefts[b])
    if flip_first and bool(flip[b]):
        left = raw + 2 * padding - left - size
    t, l = int(tops[b]) - padding, left - padding
    x[b, max(t, 0):t + size, max(l, 0):l + size] = 0


@pytest.mark.parametrize("case", ["acceptance", "wrn", "cifar", "gray"])
def test_kernel_pair_plain_versions_compose_to_the_peephole(case):
    """``crop_apply_ref`` over ``crop_stats_ref`` (the two kernels' plain
    versions) is ``crop_augment_ref`` (the JAX peephole ported), with the
    degenerate verdict on the crop as flipped (every even image is zero
    where its crop comes from), and the wrapper on a CPU tensor runs the
    latter without counting a launch."""
    g = torch.Generator().manual_seed(12)
    c = 1 if case == "gray" else 3
    n, raw, size = 8, 20, (12, 12)
    images = torch.from_numpy(_banded(n, raw, raw, c, "uint8", 13, ((3, 17), (2, 18))))
    images[1] = 254 + (torch.arange(raw)[None, :, None, None] % 2).to(torch.uint8)
    padding = 4 if case == "cifar" else 0
    flip_first = case in ("wrn", "cifar")
    if case == "cifar":
        images = images.float() / 255.0
    jitter = None
    if case in ("acceptance", "gray"):
        jitter = P.draw_color_jitter(images.float(), g, brightness=0.3, contrast=0.3,
                                     saturation=0.3, hue=0.2)
    d = P.draw_random_crop(images, g, size=size, padding=padding)
    flip = P.draw_random_hflip(images, g)["flip"]
    for b in range(0, n, 2):
        _zero_source_window(images, d["tops"], d["lefts"], flip, flip_first, size[0], padding, b)
    noise = torch.randn(n, *size, 3, generator=g)
    kw = dict(size=size, padding=padding, flip_first=flip_first, jitter=jitter,
              repeat=case == "gray", noise=noise, noise_std=0.05,
              norm=((0.5, 0.4, 0.3), (0.2, 0.3, 0.4)))
    ref = A.crop_augment_ref(images, d["tops"], d["lefts"], flip, guard=True, **kw)
    mean, degenerate = A.crop_stats_ref(
        images, d["tops"], d["lefts"], flip, size=size, padding=padding, flip_first=flip_first,
        brightness=jitter.get("brightness") if jitter else None, contrast=jitter is not None,
        guard=True)
    assert degenerate[::2].all() and not degenerate[1::2].any()
    pair = A.crop_apply_ref(images, d["tops"], d["lefts"], flip, mean, degenerate, **kw)
    assert torch.equal(pair, ref)
    before = (A.launches, A.stats_launches)
    out = A.crop_augment(images, d["tops"], d["lefts"], flip, guard=True, **kw)
    assert torch.equal(out, ref) and (A.launches, A.stats_launches) == before
