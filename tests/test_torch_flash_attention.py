"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` computes its forward with the plain
version ``flash_attention_ref``; both are held here against JAX's
``flash_attention``, whose Pallas kernel ``_kernel`` runs in interpret mode
(as tests/test_attention.py runs it), and its gradient against ``jax.grad``
through the same function. The CUDA kernel itself is compared with the plain
version on a card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
from eoe_tpu.ops.attention import flash_attention as jax_flash_attention
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, from_flax
from eoe_tpu_torch.ops import attention as A

# tests/test_attention.py's shapes (n, heads, S, d), then the CUDA kernel's tile
# edges: one past a 64-key tile, one past the 128 rows of one block, and
# d=128 at the longest whole-sequence block
SHAPES = [(2, 4, 50, 64), (2, 2, 77, 32), (1, 1, 128, 64), (1, 2, 65, 64), (1, 2, 129, 32),
          (1, 1, 128, 128)]
# tests/test_attention.py's tiny CLIP (heads of 16)
TINY = dict(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=32,
            vision_patch_size=8, context_length=16, vocab_size=64, transformer_width=32,
            transformer_heads=2, transformer_layers=1, vision_heads_override=2)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


def _causal(s):
    return np.triu(np.full((s, s), -np.inf, np.float32), k=1)


def _jax(q, k, v, mask, dtype=jnp.float32):
    out = jax_flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                              None if mask is None else jnp.asarray(mask))
    return np.asarray(out, np.float32)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _ids(shape):
    return "n{}-h{}-s{}-d{}".format(*shape)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_flash_matches_jax(shape, masked):
    """fp32 to 1e-5, tests/test_attention.py's own tolerance. On a CPU tensor
    the wrapper is the plain version and launches nothing."""
    q, k, v = _qkv(shape)
    mask = _causal(shape[2]) if masked else None
    expected = _jax(q, k, v, mask)
    ref = A.flash_attention_ref(*_torch(q, k, v, mask))
    np.testing.assert_allclose(ref.numpy(), expected, atol=1e-5)
    before = A.flash_attention.launches
    assert torch.equal(A.flash_attention(*_torch(q, k, v, mask)), ref)
    assert A.flash_attention.launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_flash_matches_jax_bf16(shape):
    """bf16: both round the normalised P to bf16 and the fp32 P.V sum once,
    so they differ at most where a sum order flips a rounding: one bf16 ulp
    at |out| < 4 is 2^-6."""
    q, k, v = _qkv(shape, seed=1)
    mask = _causal(shape[2])
    expected = _jax(q, k, v, mask, jnp.bfloat16)
    ours = A.flash_attention_ref(*(t.bfloat16() for t in _torch(q, k, v)), torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), expected, atol=2 ** -6)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
def test_flash_gradients_match_jax(masked):
    """The backward differentiates ``default_attention`` on both sides; 1e-4
    as in tests/test_attention.py."""
    shape = (1, 2, 50, 32)
    q, k, v = _qkv(shape, seed=2)
    mask = _causal(shape[2]) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    expected = jax.grad(lambda *a: (jax_flash_attention(*a, jmask) ** 2).sum(),
                        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    inputs = [t.requires_grad_() for t in _torch(q, k, v)]
    A.flash_attention(*inputs, *_torch(mask)).square().sum().backward()
    for t, g in zip(inputs, expected):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4)


def test_long_sequences_run_default_attention():
    """Above MAX_SINGLE_BLOCK both packages run ``default_attention``."""
    shape = (1, 1, A.MAX_SINGLE_BLOCK + 6, 16)
    q, k, v = _qkv(shape, seed=3)
    mask = _causal(shape[2])
    before = A.flash_attention.launches
    ours = A.flash_attention(*_torch(q, k, v, mask))
    assert torch.equal(ours, A.default_attention(*_torch(q, k, v, mask)))
    assert A.flash_attention.launches == before
    np.testing.assert_allclose(ours.numpy(), _jax(q, k, v, mask), atol=1e-5)


def test_fully_masked_row_is_nan_as_in_jax():
    """A row whose every key is masked is NaN in the JAX kernel and in the
    plain version; the other rows stay finite and agree."""
    shape = (1, 1, 20, 32)
    q, k, v = _qkv(shape, seed=4)
    mask = _causal(20)
    mask[5] = -np.inf
    expected = _jax(q, k, v, mask)
    ours = A.flash_attention_ref(*_torch(q, k, v, mask)).numpy()
    assert np.isnan(expected[0, 0, 5]).all() and np.isnan(ours[0, 0, 5]).all()
    rows = np.arange(20) != 5
    assert np.isfinite(ours[0, 0, rows]).all()
    np.testing.assert_allclose(ours[0, 0, rows], expected[0, 0, rows], atol=1e-5)


@pytest.mark.parametrize("d", [257, 300])
def test_flash_takes_wide_heads(d):
    """Head dims above 256 run, as the JAX kernel runs any d (it pads d to a
    multiple of 128): fp32 to 1e-5 against it in interpret mode, with a
    random finite mask."""
    shape = (1, 2, 20, d)
    q, k, v = _qkv(shape, seed=6)
    mask = np.random.default_rng(7).normal(0, 1, (20, 20)).astype(np.float32)
    expected = _jax(q, k, v, mask)
    before = A.flash_attention.launches
    ours = A.flash_attention(*_torch(q, k, v, mask))
    assert A.flash_attention.launches == before
    assert ours.shape == shape
    np.testing.assert_allclose(ours.numpy(), expected, atol=1e-5)


def test_clip_with_flash_attention_matches_jax():
    """tests/test_attention.py's tiny CLIP with ``attention_fn=flash_attention``
    on both sides, weights carried by ``from_flax``: image and text features
    to 1e-4."""
    rng = np.random.default_rng(5)
    images = rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    tokens = rng.integers(1, 64, (3, 16)).astype(np.int32)
    jm = JaxCLIP(JaxConfig(**TINY), attention_fn=jax_flash_attention)
    params = jm.init(jax.random.key(0), jnp.asarray(images), jnp.asarray(tokens),
                     method=jm.contrastive)["params"]
    j_img = np.asarray(jm.apply({"params": params}, jnp.asarray(images), method=jm.encode_image))
    j_txt = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens), method=jm.encode_text))

    model = CLIP(ClipConfig(**TINY), attention_fn=A.flash_attention)
    model.load_state_dict(from_flax(jax.device_get(params)))
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(img, j_img, atol=1e-4)
    np.testing.assert_allclose(txt, j_txt, atol=1e-4)


def test_attention_hooks_exclude_each_other():
    with pytest.raises(ValueError, match="not both"):
        CLIP(ClipConfig(**TINY), qkv_attention=A.fused_qkv_attention_ref,
             attention_fn=A.flash_attention)
