"""The port's fused QKV attention against the JAX package's.

On the CPU the port's wrapper computes with its plain versions,
``fused_qkv_attention_fwd_ref`` and ``fused_qkv_attention_bwd_ref``; they are
held here against JAX's Pallas kernels (in interpret mode, as
tests/test_attention.py runs them: the backward through ``jax.vjp``) and the
forward against JAX's ``default_attention``. The CUDA kernels themselves are
compared with the plain versions on a card by tests/test_torch_kernels.py and
chip_smoke.py.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eoe_tpu.ops.attention as JA
from eoe_tpu.models.clip.model import default_attention as jax_default_attention
from eoe_tpu.ops.attention import fused_qkv_attention as jax_fused_qkv_attention
from eoe_tpu_torch.ops import attention as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n, s, heads, d, causal): the JAX tests' shapes plus both CLIP encoders'
CASES = [(3, 50, 4, 64, False), (2, 21, 2, 64, True), (2, 10, 2, 128, True),
         (2, 50, 12, 64, False), (2, 77, 8, 64, True)]
# and where the fp32 backward kernel changes its design: the last sequence
# whose P and dS tables fit beside four tiles at d=64, and two at d=128 past
# that limit, where the kernel recomputes them (the longest among them)
BWD_CASES = CASES + [(2, 96, 2, 64, True), (2, 97, 2, 128, False), (2, 128, 2, 128, True)]


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


def test_fused_qkv_ok_honours_eoe_tpu_fused_attn(monkeypatch):
    """As the JAX gate (eoe_tpu/ops/attention.py:619-620): unless
    ``EOE_TPU_FUSED_ATTN`` is unset or "1", read at call time, the kernels do
    not apply and the model takes ``default_attention``."""
    on_card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    monkeypatch.delenv("EOE_TPU_FUSED_ATTN", raising=False)
    assert A.fused_qkv_ok(4, 50, 12, 64, on_card)
    for value, applies in (("0", False), ("", False), ("true", False), ("1", True)):
        monkeypatch.setenv("EOE_TPU_FUSED_ATTN", value)
        assert A.fused_qkv_ok(4, 50, 12, 64, on_card) is applies


@pytest.mark.parametrize("max_r", [16, 48, 64, 80, 96, 128])
def test_gate_honours_max_r(monkeypatch, max_r):
    """``MAX_R`` (``EOE_TPU_ATTN_MAX_R``) bounds the fused path as in the
    JAX package: for every sequence up to the kernels' 128 rows the port's
    gate says what the JAX shape condition says (round_up(s, 16) <= MAX_R),
    above 128 it says no, and the port's ``_check_fused_shape`` raises
    exactly where the JAX one does."""
    monkeypatch.setattr(A, "MAX_R", max_r)
    monkeypatch.setattr(JA, "MAX_R", max_r)
    on_card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    for s in range(1, 141):
        try:
            JA._check_fused_shape(8, 64, s)
            jax_takes = True
        except ValueError:
            jax_takes = False
        assert A.fused_qkv_ok(4, s, 8, 64, on_card) is (jax_takes and s <= 128), s
        try:
            A._check_fused_shape(8, 64, s)
            port_takes = True
        except ValueError:
            port_takes = False
        assert port_takes is jax_takes, s


def test_max_r_is_read_from_the_environment_at_import():
    """``EOE_TPU_ATTN_MAX_R=64`` at import sends the text tower (s=77, 80
    padded rows) to ``default_attention`` and keeps the image tower (s=50,
    64 rows) on the kernels."""
    code = ("import types; from eoe_tpu_torch.ops import attention as A; "
            "c = types.SimpleNamespace(is_cuda=True); "
            "print(A.MAX_R, A.fused_qkv_ok(4, 77, 8, 64, c), A.fused_qkv_ok(4, 50, 12, 64, c))")
    env = dict(os.environ, EOE_TPU_ATTN_MAX_R="64", EOE_TPU_FUSED_ATTN="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["64", "False", "True"]


def _dout(n, s, h, d, seed=2):
    return np.random.default_rng(seed).normal(0, 1, (n, s, h * d)).astype(np.float32)


def _jax_bwd(qkv, dout, h, causal, dtype):
    _, vjp = jax.vjp(lambda x: jax_fused_qkv_attention(x, h, causal), jnp.asarray(qkv, dtype))
    return np.asarray(vjp(jnp.asarray(dout, dtype))[0], np.float32)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "n{}-s{}-h{}-d{}-{}".format(
    *c[:4], "causal" if c[4] else "full"))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_jax(case, dtype):
    """The plain backward against the Pallas backward: fp32 to 1e-4 (the JAX
    tests' own), bf16 to 2^-5 of the largest gradient (both round P and dS to
    bf16 once and the output once; a sum-order flip moves one rounding)."""
    n, s, h, d, causal = case
    qkv, dout = _qkv(n, s, h, d), _dout(n, s, h, d)
    tdt = getattr(torch, dtype)
    pallas = _jax_bwd(qkv, dout, h, causal, getattr(jnp, dtype))
    ours = A.fused_qkv_attention_bwd_ref(torch.from_numpy(qkv).to(tdt),
                                         torch.from_numpy(dout).to(tdt), h, causal)
    assert ours.dtype == tdt and ours.shape == qkv.shape
    atol = 1e-4 if dtype == "float32" else 2 ** -5 * np.abs(pallas).max()
    np.testing.assert_allclose(ours.float().numpy(), pallas, atol=atol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "n{}-s{}-h{}-d{}-{}".format(
    *c[:4], "causal" if c[4] else "full"))
def test_cpu_function_gradient_is_the_plain_backward(case):
    """On a CPU tensor the autograd Function's backward is the plain backward
    (held against JAX above) and launches nothing; the differentiable
    ``fused_qkv_attention_ref`` is the same pair."""
    n, s, h, d, causal = case
    qkv, dout = _qkv(n, s, h, d), _dout(n, s, h, d)
    expected = A.fused_qkv_attention_bwd_ref(torch.from_numpy(qkv), torch.from_numpy(dout),
                                             h, causal)
    launches = (A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches)
    for fn in (A.fused_qkv_attention, A.fused_qkv_attention_ref):
        x = torch.from_numpy(qkv).requires_grad_()
        fn(x, h, causal).backward(torch.from_numpy(dout))
        assert torch.equal(x.grad, expected)
    assert (A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches) == launches


def test_plain_backward_is_not_autograd_of_the_plain_forward():
    """In bf16 autograd through the plain forward rounds dP, the JAX kernel
    rounds dS: the plain backward follows the kernel, so the two differ."""
    n, s, h, d = 2, 21, 2, 64
    qkv = torch.from_numpy(_qkv(n, s, h, d, seed=3)).bfloat16()
    dout = torch.from_numpy(_dout(n, s, h, d, seed=4)).bfloat16()
    x = qkv.clone().requires_grad_()
    A.fused_qkv_attention_fwd_ref(x, h, True).backward(dout)
    ours = A.fused_qkv_attention_bwd_ref(qkv, dout, h, True)
    pallas = _jax_bwd(qkv.float().numpy(), dout.float().numpy(), h, True, jnp.bfloat16)
    ours_err = np.abs(ours.float().numpy() - pallas).max()
    autograd_err = np.abs(x.grad.float().numpy() - pallas).max()
    assert ours_err < autograd_err
