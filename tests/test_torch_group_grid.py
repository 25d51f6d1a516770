"""The port's lane-group grid against the JAX package's.

``EOE_TPU_ATTN_GROUP_GRID=1`` makes the JAX package run the fused QKV
attention through ``_fwd_group_compute`` and ``_bwd_group_compute``; the
port's ``GROUP_GRID`` chooses the same grid for its CUDA kernels. Here JAX's
``GROUP_GRID`` is set to True for the test (``_group_grid_call`` counts its
entries, so each test shows that the JAX side took the group route) and the
port, with its ``GROUP_GRID`` on, is held against it on CPU tensors, where
it computes with the plain versions. The CUDA kernels on that grid are
compared with the plain versions and the monolithic kernels on a card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eoe_tpu.ops.attention as JA
from eoe_tpu_torch.ops import attention as A

# (n, s, heads, d, causal): tests/test_torch_attention.py's cases
CASES = [(3, 50, 4, 64, False), (2, 21, 2, 64, True), (2, 10, 2, 128, True),
         (2, 50, 12, 64, False), (2, 77, 8, 64, True)]
COUNTERS = ("launches", "bwd_launches", "group_launches", "group_bwd_launches")


def _case_id(c):
    return "n{}-s{}-h{}-d{}-{}".format(*c[:4], "causal" if c[4] else "full")


@pytest.fixture
def group_grid(monkeypatch):
    """Both packages on the group grid; returns the kinds ("fwd", "bwd") of
    the JAX package's ``_group_grid_call`` entries."""
    entered = []
    original = JA._group_grid_call

    def counting(kind, *args, **kw):
        entered.append(kind)
        return original(kind, *args, **kw)

    monkeypatch.setattr(JA, "_group_grid_call", counting)
    monkeypatch.setattr(JA, "GROUP_GRID", True)
    monkeypatch.setattr(A, "GROUP_GRID", True)
    return entered


def _arrays(n, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, s, 3 * h * d)).astype(np.float32),
            rng.normal(0, 1, (n, s, h * d)).astype(np.float32))


def _counters():
    return [getattr(A.fused_qkv_attention, c) for c in COUNTERS]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_group_forward_matches_jax(group_grid, case):
    n, s, h, d, causal = case
    qkv, _ = _arrays(n, s, h, d)
    # a fresh jit closure traces with the group grid on
    pallas = np.asarray(jax.jit(lambda x: JA.fused_qkv_attention(x, h, causal))(jnp.asarray(qkv)))
    assert group_grid == ["fwd"]
    before = _counters()
    ours = A.fused_qkv_attention(torch.from_numpy(qkv), h, causal)
    assert _counters() == before          # CPU tensors launch nothing
    np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_backward_matches_jax(group_grid, case, dtype):
    """d(qkv) against ``jax.vjp`` on the group grid: fp32 to 1e-4, bf16 to
    2^-5 of the largest gradient (the tolerances of the monolithic
    backward's test: both round P and dS to bf16 once and the output once)."""
    n, s, h, d, causal = case
    qkv, dout = _arrays(n, s, h, d, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x: JA.fused_qkv_attention(x, h, causal), jnp.asarray(qkv, jdt))
    pallas = np.asarray(vjp(jnp.asarray(dout, jdt))[0], np.float32)
    assert group_grid == ["fwd", "bwd"]
    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    before = _counters()
    A.fused_qkv_attention(x, h, causal).backward(torch.from_numpy(dout).to(tdt))
    assert _counters() == before
    assert x.grad.dtype == tdt
    atol = 1e-4 if dtype == "float32" else 2 ** -5 * np.abs(pallas).max()
    np.testing.assert_allclose(x.grad.float().numpy(), pallas, atol=atol)


def test_group_grid_chooses_the_group_kernels(monkeypatch):
    """Off the CPU the wrapper dispatches on ``GROUP_GRID``, read at call
    time, to the group kernels or the monolithic ones, forward and backward.
    Tensors on the meta device stand in for CUDA tensors and stand-ins for the
    launchers record which one was called."""
    called = []

    def stand_in(name):
        def launch(qkv, *args):
            called.append(name)
            n, s, F = qkv.shape
            return torch.empty(n, s, F if "bwd" in name else F // 3, device=qkv.device)
        return launch

    for name in ("_fwd_kernel", "_bwd_kernel", "_group_fwd_kernel", "_group_bwd_kernel"):
        monkeypatch.setattr(A, name, stand_in(name))
    for group in (False, True):
        monkeypatch.setattr(A, "GROUP_GRID", group)
        x = torch.empty(2, 10, 3 * 2 * 64, device="meta", requires_grad=True)
        A.fused_qkv_attention(x, 2, True).sum().backward()
    assert called == ["_fwd_kernel", "_bwd_kernel", "_group_fwd_kernel", "_group_bwd_kernel"]
