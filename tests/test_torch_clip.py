"""The port's CLIP, weight bridge and tokenizer against the JAX package's.

One tiny random CLIP (embed 64, 32 px, patch 8 so s=17, vision and text
width 128 with 2 heads of 64 and 2 layers, context 77) is initialised by the
port, carried to a Flax params tree with ``convert.to_flax_numpy`` and run
by both packages on the same inputs made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
from eoe_tpu.models.clip import tokenize as jax_tokenize
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, from_flax, to_flax_numpy, tokenize
from eoe_tpu_torch.ops.attention import fused_qkv_attention_ref
from eoe_tpu_torch.training.clip import CIFAR10_LABELS

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408,
            transformer_width=128, transformer_heads=2, transformer_layers=2,
            vision_heads_override=2)
# tests/test_clip.py's golden prompts, then the CIFAR-10 one-vs-rest prompts
PROMPTS = (["a photo of a cat", "a photo of something", "a photo of a airplane", "hello world"]
           + [f"a photo of a {c}" for c in CIFAR10_LABELS])


@pytest.fixture(scope="module")
def tiny():
    sd = CLIP(ClipConfig(**TINY), generator=torch.Generator().manual_seed(0)).state_dict()
    return to_flax_numpy(sd), sd


def _port(sd, dtype=torch.float32, **kw):
    model = CLIP(ClipConfig(**TINY), dtype=dtype, **kw)
    model.load_state_dict(sd)
    return model.eval()


def _jax(params, method, *args, dtype=jnp.float32):
    jm = JaxCLIP(JaxConfig(**TINY), dtype=dtype)
    fn = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=getattr(jm, method)))
    out = fn(params, *args)
    return tuple(np.asarray(o, np.float32) for o in out) if isinstance(out, tuple) \
        else np.asarray(out, np.float32)


def _inputs(seed=0, n=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
    tokens = tokenize(PROMPTS[:n])
    return images, tokens


def test_bridge_round_trip_is_exact(tiny):
    params, sd = tiny
    # the carried tree has exactly the JAX model's paths and shapes
    jm = JaxCLIP(JaxConfig(**TINY))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            jnp.zeros((1, 77), jnp.int32),
                                            method=jm.contrastive))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)
    back = from_flax(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(sd[k], back[k]) for k in sd)
    again = to_flax_numpy(back)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves_with_path(again)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _port(back)  # loads strictly: every key and shape matches the module


@pytest.mark.parametrize("attention", ["dispatch", "fused_ref"])
def test_encoders_match_jax_fp32(tiny, attention):
    """atol 2e-4, tests/test_clip.py's convention. ``fused_ref`` runs every
    block through the kernel's plain version instead of the CPU dispatch."""
    params, sd = tiny
    kw = {"qkv_attention": fused_qkv_attention_ref} if attention == "fused_ref" else {}
    model = _port(sd, **kw)
    images, tokens = _inputs()
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
        li, lt = (t.numpy() for t in model.contrastive(torch.from_numpy(images),
                                                       torch.from_numpy(tokens).long()))
    np.testing.assert_allclose(img, _jax(params, "encode_image", jnp.asarray(images)), atol=2e-4)
    np.testing.assert_allclose(txt, _jax(params, "encode_text", jnp.asarray(tokens)), atol=2e-4)
    jli, jlt = _jax(params, "contrastive", jnp.asarray(images), jnp.asarray(tokens))
    # logits are 100/7 x cosines: 2e-4 on the features is ~2e-3 here
    np.testing.assert_allclose(li, jli, atol=2e-3)
    np.testing.assert_allclose(lt, jlt, atol=2e-3)


def test_encoders_match_jax_bf16(tiny):
    """bf16 compute, fp32 params, on both sides. The two frameworks round the
    dense layers' outputs at other places (flax adds the bias after rounding
    the product, torch's addmm before), so the features (|f| ~ 1-4) drift by
    a few bf16 ulps per layer: held to 0.1, tests/test_clip.py's bf16 bound."""
    params, sd = tiny
    model = _port(sd, dtype=torch.bfloat16)
    images, tokens = _inputs(seed=1)
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).float().numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).float().numpy()
    jimg = _jax(params, "encode_image", jnp.asarray(images), dtype=jnp.bfloat16)
    jtxt = _jax(params, "encode_text", jnp.asarray(tokens), dtype=jnp.bfloat16)
    assert np.abs(img - jimg).max() < 0.1
    assert np.abs(txt - jtxt).max() < 0.1


def test_tokenizer_ids_match_jax():
    np.testing.assert_array_equal(tokenize(PROMPTS), jax_tokenize(PROMPTS))
    np.testing.assert_array_equal(tokenize("a photo of a cat")[0, :7],
                                  [49406, 320, 1125, 539, 320, 2368, 49407])


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        CLIP(ClipConfig(vision_layers=(3, 4, 6, 3), vision_width=64, vision_patch_size=None))
