"""The port's evaluation preprocessing against the JAX package's
``compile_pipeline``, on the same numpy images, at atol 1e-5."""

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
    for spec in [{"op": "random_crop", "size": 8}, "random_hflip", {"op": "gaussian_noise",
                                                                    "std": 0.1}]:
        with pytest.raises(P.PipelineError, match="not ported yet"):
            P.compile_pipeline([spec])
    with pytest.raises(P.PipelineError, match="unknown"):
        P.compile_pipeline(["no_such_op"])
    with pytest.raises(P.PipelineError, match="statistics"):
        P.compile_pipeline(["normalize"])
    assert P.DatasetStats.from_json(P.DatasetStats((0.1,), (0.2,)).to_json()) == \
        P.DatasetStats((0.1,), (0.2,), 0)
