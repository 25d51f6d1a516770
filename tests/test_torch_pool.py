"""The port's ``ops.pool`` (NCHW) against the JAX package's (NHWC) and
against ``F.max_pool2d``'s gradient, on inputs with ties: ReLU-like maps
whose windows hold many exact zeros, where only first-argmax routing agrees.

Forward values are exact (a max). A gradient cell sums the gradients of the
windows that route to it; where two or more windows do, the two sides may
add in another order, so gradients are held to 1e-6 of their largest entry
and exactly where no cell sums more than one window's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eoe_tpu.ops.pool import max_pool as jax_max_pool
from eoe_tpu_torch.ops.pool import max_pool, max_pool_2x2_s2, max_pool_3x3_s2_p1

CASES = [   # (NCHW shape, window, strides, padding)
    ((2, 8, 56, 56), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 4, 15, 15), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((2, 4, 16, 16), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((1, 3, 7, 9), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((1, 2, 8, 8), (2, 2), (2, 2), ((1, 0), (0, 1))),
]


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def _ties(shape, seed):
    rng = np.random.default_rng(seed)
    return np.maximum(rng.normal(0, 1, shape), 0.0).astype(np.float32)


def _port_grad(x, g, win, strides, pad):
    xt = torch.from_numpy(x).requires_grad_()
    y = max_pool(xt, win, strides, pad)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_and_gradient_match_jax_with_ties(case):
    shape, win, strides, pad = CASES[case]
    x = _ties(shape, case)
    y_jax, vjp = jax.vjp(lambda a: jax_max_pool(a, win, strides, pad), jnp.asarray(_nhwc(x)))
    g = np.random.default_rng(10 + case).normal(0, 1, np.shape(y_jax)).astype(np.float32)
    (dx_jax,) = vjp(jnp.asarray(g))
    y, dx = _port_grad(x, np.ascontiguousarray(g.transpose(0, 3, 1, 2)), win, strides, pad)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(y_jax))
    overlapping = any(s < k for s, k in zip(strides, win))
    if overlapping:
        np.testing.assert_allclose(_nhwc(dx), np.asarray(dx_jax),
                                   atol=1e-6 * np.abs(dx_jax).max())
    else:
        np.testing.assert_array_equal(_nhwc(dx), np.asarray(dx_jax))


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_gradient_matches_f_max_pool2d_with_ties(case):
    """Torch's own routing (first maximal tap in row-major order) on
    symmetric padding, the one ``F.max_pool2d`` takes."""
    shape, win, strides, pad = CASES[case]
    x = _ties(shape, 20 + case)
    xt = torch.from_numpy(x).requires_grad_()
    want = F.max_pool2d(xt, win, strides, (pad[0][0], pad[1][0]))
    g = torch.from_numpy(np.random.default_rng(30 + case).normal(0, 1, want.shape)
                         .astype(np.float32))
    want.backward(g)
    y, dx = _port_grad(x, g.numpy(), win, strides, pad)
    np.testing.assert_array_equal(y, want.detach().numpy())
    np.testing.assert_allclose(dx, xt.grad.numpy(), atol=1e-6 * xt.grad.abs().max().item())


def test_wrappers_bf16_and_integers():
    x = torch.from_numpy(_ties((2, 4, 32, 32), 40))
    np.testing.assert_array_equal(max_pool_3x3_s2_p1(x).numpy(),
                                  F.max_pool2d(x, 3, 2, 1).numpy())
    np.testing.assert_array_equal(max_pool_2x2_s2(x).numpy(), F.max_pool2d(x, 2, 2).numpy())
    xb = x.bfloat16().requires_grad_()
    y = max_pool_3x3_s2_p1(xb)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  F.max_pool2d(x.bfloat16(), 3, 2, 1).float().numpy())
    y.sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    xi = torch.from_numpy(np.random.default_rng(41).integers(-5, 5, (1, 2, 9, 9)))
    want = jax_max_pool(jnp.asarray(_nhwc(xi.numpy())), (3, 3), (2, 2), ((1, 1), (1, 1)))
    np.testing.assert_array_equal(_nhwc(max_pool_3x3_s2_p1(xi).numpy()), np.asarray(want))
