"""The port's filters (``ops.filters``), the filter specs of its pipelines
and its label-conditional pipelines against the JAX package's, on the same
numpy images.

Tolerance: 1e-5 of max(1, the JAX result's largest magnitude), and NaN
exactly where the JAX result is NaN: the DFT filters zero every frequency
at a magnitude of half the side or more, and min-max renormalising then
divides 0 by 0 in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops import filters as JF
from eoe_tpu.ops import preprocess as JP
from eoe_tpu_torch.ops import filters as F
from eoe_tpu_torch.ops import preprocess as P

TOL = 1e-5


def _images(shape=(3, 32, 32, 3), seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


def _hold(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    finite = ~np.isnan(ref)
    scale = max(1.0, float(np.abs(ref[finite]).max())) if finite.any() else 1.0
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=0, atol=TOL * scale)


CASES = [("gaussian_blur", dict(sigma=s)) for s in (0.0, 0.5, 1.0, 3.0, 8.0, 40.0)] + \
        [("unsharp_mask", dict(percent=p)) for p in (0.0, 100.0, 300.0)] + \
        [(f, dict(magnitude=m)) for f in ("high_pass_filter", "low_pass_filter")
         for m in (0, 1, 15, 16)] + \
        [("global_contrast_normalization", dict(scale=s)) for s in ("l1", "l2")] + \
        [("minmax_norm", {}), ("grayscale", {})]


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{kw}" for n, kw in CASES])
def test_filter_matches_jax(name, kw):
    images = _images()
    ours = getattr(F, name)(torch.from_numpy(images), **kw)
    ref = getattr(JF, name)(jnp.asarray(images), **kw)
    _hold(ours.numpy(), ref)
    expect_nan = name.endswith("pass_filter") and kw["magnitude"] >= 16
    assert np.isnan(np.asarray(ref)).all() == expect_nan   # the JAX result, as it is


@pytest.mark.parametrize("name", sorted(JF.FILTERS))
def test_filter_registry_matches_jax(name):
    assert sorted(F.FILTERS) == sorted(JF.FILTERS)
    images = _images((2, 16, 16, 3), seed=1)
    for m in (0, 1, 2, 8):
        _hold(F.FILTERS[name](torch.from_numpy(images), m).numpy(),
              JF.FILTERS[name](jnp.asarray(images), m))


def test_kornia_kernel_size_matches_jax():
    for sigma in (0.1, 1.0, 1.9, 2.0, 3.5, 8.0, 16.0, 33.0, 100.0):
        for size in (5, 16, 28, 32, 224):
            assert F.kornia_kernel_size(sigma, size) == JF.kornia_kernel_size(sigma, size)


STATS = {"std": ((0.4, 0.45, 0.5), (0.2, 0.25, 0.3), 0), "gray": ((0.45,), (0.25,), 0),
         "gcn": ((-3.0,) * 3, (7.0,) * 3, 1)}
PIPELINES = [
    (["grayscale", "normalize"], "gray"),
    (["grayscale", {"op": "center_crop", "size": 24}], None),
    ([{"op": "blur", "sigma": 2.0}, "normalize"], "std"),
    ([{"op": "sharpen", "percent": 200.0}], None),
    ([{"op": "lpf", "magnitude": 8}, {"op": "hpf", "magnitude": 2}], None),
    ([{"op": "lpf", "magnitude": 16}, "minmax_norm"], None),
    (["gcn"], None), ([{"op": "gcn", "scale": "l2"}], None),
    (["gcn-normalize"], "gcn"), ([{"op": "resize", "size": 24}, "gcn-norm"], "gcn"),
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("specs,stats", PIPELINES, ids=[str(p[0]) for p in PIPELINES])
def test_filter_specs_match_jax(specs, stats, dtype):
    images = _images(dtype=dtype, seed=2)
    st = STATS.get(stats)
    ours = P.compile_pipeline(specs, st and P.DatasetStats(*st))(torch.from_numpy(images))
    ref = JP.compile_pipeline(specs, st and JP.DatasetStats(*st))(jnp.asarray(images))
    assert ours.dtype == torch.float32
    _hold(ours.numpy(), ref)


CONDITIONALS = [
    [(0, [{"op": "lpf", "magnitude": 4}], None)],                        # train_nominal
    [(0, [{"op": "blur", "sigma": 2.0}], [{"op": "blur", "sigma": 2.0}])],  # train_oe
    [(0, None, [{"op": "hpf", "magnitude": 8}])],                         # test_anomalous
    [(0, [{"op": "sharpen", "percent": 300.0}], None),                    # two in a row
     (0, None, [{"op": "hpf", "magnitude": 16}])],
    [(1, ["gcn-normalize"], None)],
]


@pytest.mark.parametrize("main", [[], [{"op": "center_crop", "size": 24}, "normalize"],
                                  [{"op": "resize", "size": 40}]])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("conds", CONDITIONALS, ids=range(len(CONDITIONALS)))
def test_conditional_then_pipeline_match_jax(conds, dtype, main):
    """Both branches on the whole batch, merged by label (mixed labels,
    unlabeled -1 among them); floats hand on to the main pipeline, whose
    index-only prefix then runs on floats, as in JAX."""
    images = _images(dtype=dtype, seed=3, shape=(6, 32, 32, 3))
    labels = np.array([0, 1, 0, -1, 1, 0])
    st = STATS["gcn"] if any("gcn-normalize" in (t or []) for _, t, _ in conds) else STATS["std"]
    ours_c = P.compile_conditional(conds, P.DatasetStats(*st))
    ref_c = JP.compile_conditional(conds, JP.DatasetStats(*st))
    ours = ours_c(torch.from_numpy(images), torch.from_numpy(labels))
    ref = ref_c(jnp.asarray(images), jnp.asarray(labels))
    assert ours.dtype == torch.float32 and ours_c.random_ops == []
    _hold(ours.numpy(), ref)
    ours = P.compile_pipeline(main, P.DatasetStats(*STATS["std"]))(ours)
    ref = JP.compile_pipeline(main, JP.DatasetStats(*STATS["std"]))(ref)
    _hold(ours.numpy(), ref)


def test_empty_conditional_passes_uint8_through():
    images = torch.from_numpy(_images(dtype="uint8", seed=4))
    ours = P.compile_conditional([])(images, torch.zeros(3))
    ref = JP.compile_conditional([])(jnp.asarray(images.numpy()), jnp.zeros(3))
    assert ours is images and np.asarray(ref).dtype == np.uint8


def test_conditional_branches_draw_in_spec_order():
    """A random spec in a branch draws from the generator, or takes the
    given draws, in spec order: the first branch's, then the second's."""
    conds = [(0, [{"op": "random_hflip"}], [{"op": "gaussian_noise", "std": 0.1}]),
             (1, None, [{"op": "random_crop", "size": 32, "padding": 2}])]
    fn = P.compile_conditional(conds)
    assert fn.random_ops == ["random_hflip", "gaussian_noise", "random_crop"]
    images = torch.from_numpy(_images((4, 32, 32, 3), seed=5))
    labels = torch.tensor([0, 1, 0, 1])
    flip = {"flip": torch.tensor([True, False, False, True])}
    noise = {"noise": torch.ones(4, 32, 32, 3)}
    crop = {"tops": torch.full((4,), 2), "lefts": torch.full((4,), 2)}
    out = fn(images, labels, draws=[flip, noise, crop])
    # the second conditional crops the 2-padded images at (2, 2): themselves
    expect = torch.where(labels.reshape(-1, 1, 1, 1) == 0, P.random_hflip(images, **flip),
                         images + 0.1)
    torch.testing.assert_close(out, expect, rtol=0, atol=0)
    a = fn(images, labels, generator=torch.Generator().manual_seed(0))
    b = fn(images, labels, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
