"""The port's fused WideResNet stem (``ops.stem``) against the JAX package's
``fused_stem_train`` (a ``custom_vjp``) and against the port's plain stem
under autograd, on the CPU at small sizes.

Layouts: the port takes NCHW images and an (out, in, 7, 7) kernel, JAX NHWC
and HWIO; the inputs are numpy-seeded normals, so every pooling window
whose maximum survives the ReLU has a strict maximum (ties are ReLU zeros,
which the mask drops on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops.stem import fused_stem_train as jax_fused_stem
from eoe_tpu_torch.models.resnet import WideResNet
from eoe_tpu_torch.ops import stem as S

FWD_TOL = 1e-5     # outputs and batch statistics
GRAD_TOL = 1e-4    # gradients, of their largest magnitude


def _inputs(n=2, hw=32, seed=0, beta=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
    w = rng.normal(scale=0.1, size=(7, 7, 3, 64)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=64).astype(np.float32)
    beta = (rng.normal(scale=0.1, size=64) + beta).astype(np.float32)
    cot = rng.normal(size=(n, hw // 4, hw // 4, 64)).astype(np.float32)
    return x, w, gamma, beta, cot


def _port(fn, x, w, gamma, beta, cot, dtype=torch.float32, input_grad=True):
    """(out NHWC, mu, var, dw HWIO, dgamma, dbeta, dx NHWC or None)."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).requires_grad_(input_grad)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    out, mu, var = fn(wt, gt, bt, xt)
    out.float().backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    dx = xt.grad.float().permute(0, 2, 3, 1).numpy() if input_grad else None
    return (out.float().permute(0, 2, 3, 1).detach().numpy(), mu.numpy(), var.numpy(),
            wt.grad.permute(2, 3, 1, 0).numpy(), gt.grad.numpy(), bt.grad.numpy(), dx)


def _jax(x, w, gamma, beta, cot):
    (out, mu, var), vjp = jax.vjp(jax_fused_stem, jnp.asarray(w), jnp.asarray(gamma),
                                  jnp.asarray(beta), jnp.asarray(x))
    dw, dg, db, dx = vjp((jnp.asarray(cot), jnp.zeros_like(mu), jnp.zeros_like(var)))
    return tuple(np.asarray(a) for a in (out, mu, var, dw, dg, db, dx))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hold(ours, theirs, grad_tol=GRAD_TOL, fwd_tol=FWD_TOL):
    names = ("out", "mu", "var", "dw", "dgamma", "dbeta", "dx")
    for name, a, b in zip(names, ours, theirs):
        if a is None or b is None:
            continue
        tol = fwd_tol if name in ("out", "mu", "var") else grad_tol
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("hw", [32, 48])
def test_fused_stem_matches_jax_vjp(hw):
    args = _inputs(hw=hw, seed=hw)
    ours = _port(S.fused_stem_train, *args)
    _hold(ours, _jax(*args))
    # every window that passes the ReLU has a strict maximum
    y = S.stats_bn_relu(S._conv7s2(torch.from_numpy(args[0]).permute(0, 3, 1, 2),
                                   torch.from_numpy(args[1].transpose(3, 2, 0, 1).copy())),
                        torch.from_numpy(args[2]), torch.from_numpy(args[3]))[0]
    windows = torch.nn.functional.unfold(y.flatten(0, 1)[:, None], 3, padding=1, stride=2)
    top2 = windows.topk(2, dim=1).values
    live = top2[:, 0] > 0
    assert live.any() and torch.all(top2[:, 0][live] > top2[:, 1][live])


def test_fused_stem_matches_plain_stem():
    args = _inputs(seed=1)
    _hold(_port(S.fused_stem_train, *args), _port(S.plain_stem, *args))


def test_image_gradient_only_on_request(monkeypatch):
    """With a leaf image batch (the training step) the backward asks the
    convolution backward for dW only; with an image that requires a
    gradient, for dx too."""
    masks = []
    real = S._conv_backward

    def spy(*args):
        masks.append(list(args[-1]))
        return real(*args)

    monkeypatch.setattr(S, "_conv_backward", spy)
    args = _inputs(seed=2)
    ours = _port(S.fused_stem_train, *args, input_grad=False)
    assert ours[-1] is None and masks == [[False, True, False]]
    _port(S.fused_stem_train, *args, input_grad=True)
    assert masks[-1] == [True, True, False]


def test_fused_stem_all_negative_gives_zero_gradients():
    """Every pooled max <= 0 (beta -100): zero, finite gradients, as the
    JAX package's tests/test_stem.py checks for its op."""
    x, w, gamma, beta, cot = _inputs(seed=5)
    beta = np.full(64, -100.0, np.float32)
    ours = _port(S.fused_stem_train, x, w, gamma, beta, cot)
    for grad in ours[3:]:
        assert np.isfinite(grad).all() and np.abs(grad).max() == 0.0
    _hold(ours, _jax(x, w, gamma, beta, cot))


def test_fused_stem_bf16_stays_close_to_plain_bf16():
    """bf16 compute (the WideResNet's bench dtype): the fused algebra against
    the plain stem, both in bf16, at the JAX test's 5e-2 of the max."""
    args = _inputs(seed=6)
    ours = _port(S.fused_stem_train, *args, dtype=torch.bfloat16)
    ref = _port(S.plain_stem, *args, dtype=torch.bfloat16)
    for a, b in zip(ours[3:6], ref[3:6]):
        assert _rel(a, b) <= 5e-2


def test_wide_resnet_switches_the_stem(monkeypatch):
    """Train mode takes the fused stem unless ``EOE_TPU_FUSED_STEM=0``; both
    give the same output and running averages, and the same gradients."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 32, 32, 3))
                         .astype(np.float32))
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("EOE_TPU_FUSED_STEM", flag)
        model = WideResNet(layers=(1, 1, 1, 1)).train()
        assert model.uses_fused_stem() == (flag == "1")
        out = model(x)
        out.square().sum().backward()
        runs.append((out.detach(), model.bn1.running_var.clone(),
                     model.conv1.weight.grad.clone(), model.bn1.weight.grad.clone()))
    for a, b in zip(*runs):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL
    assert not WideResNet(layers=(1, 1, 1, 1)).eval().uses_fused_stem()
