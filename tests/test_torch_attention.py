"""The port's fused QKV attention against the JAX package's.

On the CPU the port's wrapper computes with its plain version,
``fused_qkv_attention_ref``; it is held here against JAX's Pallas kernel (in
interpret mode, as tests/test_attention.py runs it) and against JAX's
``default_attention``. The CUDA kernel itself is compared with the plain
version on a card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.clip.model import default_attention as jax_default_attention
from eoe_tpu.ops.attention import fused_qkv_attention as jax_fused_qkv_attention
from eoe_tpu_torch.ops import attention as A

# (n, s, heads, d, causal): the JAX tests' shapes plus both CLIP encoders'
CASES = [(3, 50, 4, 64, False), (2, 21, 2, 64, True), (2, 10, 2, 128, True),
         (2, 50, 12, 64, False), (2, 77, 8, 64, True)]


def _qkv(n, s, h, d, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, s, 3 * h * d)).astype(np.float32)


def _jax_default(qkv, h, causal):
    n, s, F = qkv.shape
    d = F // 3 // h
    q, k, v = jnp.split(jnp.asarray(qkv), 3, axis=-1)
    f = lambda t: t.reshape(n, s, h, d).transpose(0, 2, 1, 3)
    mask = jnp.triu(jnp.full((s, s), -jnp.inf), k=1) if causal else None
    out = jax_default_attention(f(q), f(k), f(v), mask)
    return np.asarray(out.transpose(0, 2, 1, 3).reshape(n, s, h * d))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "n{}-s{}-h{}-d{}-{}".format(
    *c[:4], "causal" if c[4] else "full"))
def test_ref_matches_jax(case):
    n, s, h, d, causal = case
    qkv = _qkv(n, s, h, d)
    ours = A.fused_qkv_attention_ref(torch.from_numpy(qkv), h, causal).numpy()
    pallas = np.asarray(jax_fused_qkv_attention(jnp.asarray(qkv), h, causal))
    np.testing.assert_allclose(ours, pallas, atol=1e-5)
    np.testing.assert_allclose(ours, _jax_default(qkv, h, causal), atol=1e-5)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = A.fused_qkv_attention.launches
    wrapped = A.fused_qkv_attention(torch.from_numpy(qkv), h, causal)
    assert torch.equal(wrapped, torch.from_numpy(ours))
    assert A.fused_qkv_attention.launches == before


def test_ref_matches_jax_bf16():
    """bf16: both round q*2^-3 and P to bf16 and cast the fp32 P.V sum once,
    so they differ at most where a sum order flips a rounding: one bf16 ulp
    at |out| < 4 is 2^-6."""
    n, s, h, d = 2, 21, 2, 64
    qkv = _qkv(n, s, h, d, seed=1)
    ours = A.fused_qkv_attention_ref(torch.from_numpy(qkv).bfloat16(), h, True)
    pallas = jax_fused_qkv_attention(jnp.asarray(qkv, jnp.bfloat16), h, True)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(pallas, np.float32),
                               atol=2 ** -6)


def test_check_fused_shape_rejections():
    for heads, d, s in [(4, 32, 50), (3, 64, 50), (8, 16, 50), (12, 48, 50), (12, 64, 129)]:
        with pytest.raises(ValueError):
            A._check_fused_shape(heads, d, s)
    qkv = torch.zeros(2, 50, 3 * 4 * 32)
    with pytest.raises(ValueError):
        A.fused_qkv_attention(qkv, 4, False)
    with pytest.raises(ValueError):
        A.fused_qkv_attention_ref(qkv, 4, False)
    A._check_fused_shape(12, 64, 50)   # the ViT-B/32 image encoder
    A._check_fused_shape(8, 64, 77)    # the text encoder
    A._check_fused_shape(2, 128, 128)


def test_fused_qkv_ok_is_false_on_cpu():
    assert not A.fused_qkv_ok(4, 50, 12, 64, torch.zeros(4, 50, 3 * 768))
    assert not A.fused_qkv_ok(4, 50, 12, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_qkv_ok_gates_on_device_and_shape_only(dtype):
    """On the card the gate ignores the dtype, as the JAX gate does: a dtype
    the kernel does not take must reach it and raise, not run the plain
    version. A stand-in for a CUDA tensor carries the two attributes read."""
    on_card = types.SimpleNamespace(is_cuda=True, dtype=dtype)
    assert A.fused_qkv_ok(4, 50, 12, 64, on_card)
    assert A.fused_qkv_ok(4, 77, 8, 64, on_card)
    assert not A.fused_qkv_ok(4, 50, 3, 64, on_card)
    assert not A.fused_qkv_ok(4, 129, 12, 64, on_card)
