"""The port's preprocessing against the JAX package's ``compile_pipeline``,
on the same numpy images, at atol 1e-5.

For the random ops the JAX key split is repeated here to get the JAX draws
(jitter factors, crop offsets, flip bits, noise), which are injected into
the port's pipeline; the JAX side runs its compiled pipeline with its
peepholes on (``color_jitter_crop_flip``, ``random_crop_hflip``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops import preprocess as JP
from eoe_tpu_torch.ops import preprocess as P

CLIP_EVAL = [{"op": "clip_pil_preprocessing", "resolution": 224},
             {"op": "clip_tensor_preprocessing"}]


def _images(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


def _both(specs, images, stats=None):
    ours = P.compile_pipeline(specs, stats and P.DatasetStats(*stats))(torch.from_numpy(images))
    ref = JP.compile_pipeline(specs, stats and JP.DatasetStats(*stats))(jnp.asarray(images))
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("raw", [32, 256])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_clip_eval_pipeline_matches_jax(raw, dtype):
    """CIFAR-sized rasters upscale 32 -> 224, ImageNet-sized ones downscale
    256 -> 224, both by antialiased bicubic."""
    ours, ref = _both(CLIP_EVAL, _images((2, raw, raw, 3), dtype))
    assert ours.shape == ref.shape == (2, 224, 224, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("raw", [32, 256])
def test_resize_needs_antialias(raw):
    """Why ``resize`` passes ``antialias=True``: torch's plain bicubic uses
    another kernel (a=-0.75) and no antialiasing, and misses the JAX
    package's resize by far more than the 1e-5 held above."""
    images = torch.from_numpy(_images((2, raw, raw, 3), "float32")).permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(images, size=(224, 224), mode="bicubic",
                                            align_corners=False, antialias=False)
    ref = np.asarray(JP.resize(jnp.asarray(images.permute(0, 2, 3, 1).numpy()), (224, 224),
                               "cubic"))
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref).max() > 0.05


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("size", [(24, 40), (8, 8)])
def test_resize_matches_jax(method, size):
    images = _images((2, 16, 20, 3), "float32", seed=1)
    ours = P.resize(torch.from_numpy(images), size, method).numpy()
    ref = np.asarray(JP.resize(jnp.asarray(images), size, method))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("size", [(10, 12), (20, 24)])  # inside, and padded past the edge
def test_center_crop_matches_jax(size):
    images = _images((2, 16, 18, 3), "uint8", seed=2)
    ours = P.center_crop(torch.from_numpy(images), size).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JP.center_crop(jnp.asarray(images), size)))


def test_normalize_and_stats_specs_match_jax():
    images = _images((2, 12, 12, 3), "uint8", seed=3)
    stats = ((0.4, 0.5, 0.6), (0.2, 0.25, 0.3), 0)
    specs = [{"op": "resize", "size": 12}, {"op": "center_crop", "size": 10}, "to_tensor",
             "normalize", {"op": "normalize_with", "mean": [0.1, 0.2, 0.3], "std": [1, 2, 3]}]
    ours, ref = _both(specs, images, stats)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    # statistics passed at run time override the compiled ones
    rt = ((0.3, 0.3, 0.3), (0.5, 0.5, 0.5))
    ours = P.compile_pipeline(specs, P.DatasetStats(*stats))(torch.from_numpy(images), rt)
    ref = JP.compile_pipeline(specs, JP.DatasetStats(*stats))(jnp.asarray(images), None,
                                                              [jnp.asarray(v) for v in rt])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    out = P.normalize(torch.from_numpy(images).float(), *stats[:2]).numpy()
    np.testing.assert_allclose(out, np.asarray(JP.normalize(jnp.asarray(images, jnp.float32),
                                                            *stats[:2])), atol=1e-5)


def test_uint8_order():
    """Index-only ops and identity resizes keep uint8; the result is float."""
    images = _images((1, 8, 8, 3), "uint8", seed=4)
    keep = P.compile_pipeline([{"op": "resize", "size": 8}, {"op": "center_crop", "size": 6}])
    out = keep(torch.from_numpy(images))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), images[:, 1:7, 1:7].astype(np.float32) / 255.0)
    assert P._resize_u8(torch.from_numpy(images), (8, 8)).dtype == torch.uint8
    assert P._resize_u8(torch.from_numpy(images), (9, 9)).dtype == torch.float32
    gray = P.compile_pipeline([{"op": "clip_pil_preprocessing", "resolution": 8}])(
        torch.from_numpy(images[..., :1]))
    assert gray.shape == (1, 8, 8, 3)


def test_unported_and_unknown_specs_raise():
    # the filters compile (tests/test_torch_filters.py holds them against JAX)
    for spec in ["grayscale", {"op": "blur", "sigma": 1.0}, "gcn"]:
        assert P.compile_pipeline([spec]).specs == [spec]
    with pytest.raises(P.PipelineError, match="unknown"):
        P.compile_pipeline(["no_such_op"])
    for placeholder in ("normalize", "gcn-normalize"):
        with pytest.raises(P.PipelineError, match="statistics"):
            P.compile_pipeline([placeholder])
    assert P.DatasetStats.from_json(P.DatasetStats((0.1,), (0.2,)).to_json()) == \
        P.DatasetStats((0.1,), (0.2,), 0)


RANDOM_OPS = ("color_jitter", "random_crop", "random_hflip", "gaussian_noise")
# the acceptance stack of the JAX package's training benchmark (bench.py:60-68),
# at 40 px raw and 32 px crops
ACCEPTANCE = [{"op": "resize", "size": 40},
              {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
               "hue": 0.01},
              {"op": "random_crop", "size": 32, "resample_degenerate": True},
              {"op": "random_hflip", "p": 0.5},
              {"op": "clip_pil_preprocessing", "resolution": 32},
              {"op": "gaussian_noise", "std": 0.001},
              {"op": "clip_tensor_preprocessing"}]
# the CIFAR-10 stack (flip before a padded crop: JAX's flip-first peephole)
CIFAR = [{"op": "color_jitter", "brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
          "hue": 0.1},
         {"op": "random_hflip", "p": 0.5},
         {"op": "random_crop", "size": 32, "padding": 4},
         {"op": "gaussian_noise", "std": 0.05},
         {"op": "normalize_with", "mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.4]}]


def _jax_draws(specs, shape, key):
    """The draws the JAX pipeline makes from ``key``: ``keys[i]`` for the
    i-th random op, split inside each op as the op splits it."""
    n, h, w, c = shape
    keys = jax.random.split(key, sum(s["op"] in RANDOM_OPS for s in specs))
    draws, ki = [], 0
    for s in specs:
        op = s["op"]
        if op == "resize":
            h = w = s["size"]
        elif op == "clip_pil_preprocessing":
            h = w = s["resolution"]
        if op not in RANDOM_OPS:
            continue
        k = keys[ki]
        ki += 1
        if op == "color_jitter":
            d = {}
            for name, kk in zip(("brightness", "contrast", "saturation"),
                                jax.random.split(k, 4)[:3]):
                f = s.get(name, 0.0)
                if f > 0:
                    d[name] = jax.random.uniform(kk, (n, 1, 1, 1), minval=max(0.0, 1 - f),
                                                 maxval=1 + f)
            if s.get("hue", 0.0) > 0:
                d["hue"] = jax.random.uniform(jax.random.split(k, 4)[3], (n, 1, 1),
                                              minval=-s["hue"], maxval=s["hue"])
        elif op == "random_crop":
            pad, size = s.get("padding", 0), s["size"]
            k1, k2 = jax.random.split(k)
            d = {"tops": jax.random.randint(k1, (n,), 0, h + 2 * pad - size + 1),
                 "lefts": jax.random.randint(k2, (n,), 0, w + 2 * pad - size + 1)}
            h = w = size
        elif op == "random_hflip":
            d = {"flip": jax.random.bernoulli(k, s.get("p", 0.5), (n, 1, 1, 1)).reshape(n)}
        else:
            d = {"noise": jax.random.normal(k, (n, h, w, c), jnp.float32)}
        draws.append({name: torch.from_numpy(np.array(v)) for name, v in d.items()})
    return draws


def _random_both(specs, images, seed=0):
    key = jax.random.key(seed)
    draws = _jax_draws(specs, images.shape, key)
    ours = P.compile_pipeline(specs)(torch.from_numpy(images), draws=draws)
    ref = JP.compile_pipeline(specs)(jnp.asarray(images), key)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("spec", [
    {"op": "color_jitter", "brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.2},
    {"op": "color_jitter", "contrast": 0.5},
    {"op": "random_crop", "size": 12},
    {"op": "random_crop", "size": 16, "padding": 4},
    {"op": "random_hflip", "p": 0.5},
    {"op": "gaussian_noise", "std": 0.1}], ids=lambda s: "-".join(map(str, s.values())))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_op_alone_matches_jax(spec, dtype):
    ours, ref = _random_both([spec], _images((6, 16, 16, 3), dtype, seed=5))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("raw", [40, 48])  # an identity resize keeps uint8; a real one not
def test_acceptance_stack_matches_jax(raw):
    """Image 0 is constant: its crop is degenerate and falls back to the
    (flipped, where the flip bit is set) centre crop."""
    images = _images((6, raw, raw, 3), "uint8", seed=6)
    images[0] = 200
    ours, ref = _random_both(ACCEPTANCE, images, seed=1)
    assert ours.shape == ref.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    # the constant image came out as its centre crop: constant up to the noise
    assert np.ptp(ours[0] * np.array(P.CLIP_STD), axis=(0, 1)).max() < 0.01


def test_cifar_stack_matches_jax():
    ours, ref = _random_both(CIFAR, _images((6, 32, 32, 3), "uint8", seed=7), seed=2)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_degenerate_crop_falls_back_to_center():
    images = torch.zeros(2, 10, 10, 3, dtype=torch.uint8)
    images[1] = torch.arange(300, dtype=torch.uint8).reshape(10, 10, 3)
    tops, lefts = torch.tensor([0, 0]), torch.tensor([0, 0])
    out = P.random_crop(images, tops, lefts, (6, 6), resample_degenerate=True)
    assert torch.equal(out[1], images[1, :6, :6])          # not constant: kept
    assert torch.equal(out[0], P.center_crop(images, (6, 6))[0])
    ref = JP._degenerate_to_center(jnp.asarray(images[:, :6, :6].numpy()),
                                   jnp.asarray(images.numpy()), (6, 6))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generator_draws_in_spec_order():
    """With a generator the draws are made in spec order from it: the same
    seed gives the same images; no generator and no draws raises."""
    pipe = P.compile_pipeline(ACCEPTANCE)
    assert pipe.random_ops == ["color_jitter", "random_crop", "random_hflip", "gaussian_noise"]
    images = torch.from_numpy(_images((4, 40, 40, 3), "uint8", seed=8))
    a = pipe(images, generator=torch.Generator().manual_seed(3))
    b = pipe(images, generator=torch.Generator().manual_seed(3))
    c = pipe(images, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    with pytest.raises(P.PipelineError, match="no generator"):
        pipe(images)


def test_conditional_pipelines():
    identity = P.compile_conditional([])
    images = torch.zeros(2, 4, 4, 3, dtype=torch.uint8)
    assert identity(images, torch.zeros(2)) is images
    # a non-empty list converts, and each label takes its branch
    images = torch.stack([torch.zeros(4, 4, 3, dtype=torch.uint8),
                          torch.full((4, 4, 3), 255, dtype=torch.uint8)])
    out = P.compile_conditional([(0, ["grayscale"], None)])(images, torch.tensor([0, 1]))
    assert out.dtype == torch.float32 and out.shape == (2, 4, 4, 3)
    assert out[0].eq(0).all() and out[1].eq(1).all()
