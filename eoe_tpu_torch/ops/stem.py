"""The WideResNet stem in train mode with a fused backward: conv7x7 s2 -> BN
-> ReLU -> maxpool 3x3 s2 pad 1. The port of eoe_tpu/ops/stem.py.

The forward is the plain composition (``plain_stem``): the BN statistics in
fp32 as ``mean`` and ``mean(x^2) - mean^2``, the normalised output cast to
the compute dtype, Flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` in train
mode. It returns ``(pooled, mu, var)``; the caller updates its running
averages from (mu, var), which get no gradient.

The backward computes BN's two reductions on the pooled 56x56 grid instead
of the dense 112x112 one. The pooled gradient ``g`` reaches argmax positions
only, and there ``y = M = maxpool(y)``, so

    sum(dy)        = sum(g * [M > 0])
    sum(dy * xhat) = sum(g * [M > 0] * (M - beta) / gamma)

with gamma nudged off 0 (``gamma_safe``) as in the JAX package. The pooled
gradient goes back to the forward's argmax indices (the first maximum of a
window, as JAX's select-and-scatter with ``ge``), through the ReLU mask, into
BN's dx with those two sums, then into dW of the conv
(``aten.convolution_backward``). The image gradient is computed only when
autograd asks for it (``ctx.needs_input_grad``): a training step's images
are leaves, and XLA drops that conv as dead code there.

Under a data mesh of several ranks (``parallel.mesh.active``) the
statistics are the global batch's and the stem runs as ``plain_stem``: the
fused backward's grid sums are one rank's.

Convolutions and pooling run on cuDNN and torch's own kernels, as the JAX
package leaves them to XLA: no kernel of this repository lies on this path.
"""

import torch
import torch.nn.functional as F

from eoe_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum

EPS = 1e-5
_conv_backward = torch.ops.aten.convolution_backward


def _conv7s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, stride=2, padding=3)


def stats_bn_relu(xc: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Train-mode BN (Flax's) and ReLU over an NCHW tensor: (y, mu, var)."""
    xf = xc.float()
    mesh = active_mesh()
    if mesh is None:
        mu = xf.mean(dim=(0, 2, 3))
        var = (xf * xf).mean(dim=(0, 2, 3)) - mu * mu
    else:   # the global batch's statistics over a data mesh of several ranks
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        tot = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                        count]), mesh)
        mu = tot[:c] / tot[-1]
        var = tot[c:2 * c] / tot[-1] - mu * mu
    inv = torch.rsqrt(var + EPS)
    y = (xf - mu[:, None, None]) * (gamma * inv)[:, None, None] + beta[:, None, None]
    return torch.relu(y).to(xc.dtype), mu, var


def plain_stem(w, gamma, beta, x):
    """The stem as a composition of torch ops under autograd, the fused
    stem's plain version: ``(pooled, mu, var)``."""
    y, mu, var = stats_bn_relu(_conv7s2(x, w.to(x.dtype)), gamma, beta)
    return F.max_pool2d(y, 3, 2, 1), mu.detach(), var.detach()


class FusedStem(torch.autograd.Function):
    """The stem with the grid-stats backward, in the ``setup_context`` form
    that ``torch.func`` takes. Its vmap rule is generated from the torch ops
    of ``forward`` and ``backward``: each member of a vmapped batch keeps
    its own BN statistics, as the JAX package's plain vmap of the stem does
    (folding the members into the image axis would pool their statistics)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w, gamma, beta, x):
        xc = _conv7s2(x, w.to(x.dtype))
        y, mu, var = stats_bn_relu(xc, gamma, beta)
        out, idx = F.max_pool2d(y, 3, 2, 1, return_indices=True)
        return out, mu, var, xc, y, idx

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, gamma, beta, x = inputs
        out, mu, var, xc, y, idx = output
        ctx.save_for_backward(w, gamma, beta, x, xc, y, mu, var, out, idx)
        ctx.mark_non_differentiable(mu, var, xc, y, idx)

    @staticmethod
    def backward(ctx, g, _dmu, _dvar, _dxc, _dy, _didx):
        w, gamma, beta, x, xc, y, mu, var, M, idx = ctx.saved_tensors
        n_count = y.shape[0] * y.shape[2] * y.shape[3]

        # BN's reductions on the pooled grid. gamma exactly 0 would make the
        # quotient inf: nudge it off zero, keeping its sign
        tiny = torch.full_like(gamma, 1e-12)
        gamma_safe = torch.where(gamma.abs() < 1e-12, torch.where(gamma < 0, -tiny, tiny), gamma)
        gm = g.float() * (M > 0)
        sum_dy = gm.sum(dim=(0, 2, 3))
        xhat_max = (M.float() - beta[:, None, None]) / gamma_safe[:, None, None]
        sum_dyx = (gm * xhat_max).sum(dim=(0, 2, 3))

        # the pooled gradient to the argmax positions, then the ReLU mask
        dyp = torch.ops.aten.max_pool2d_with_indices_backward(
            g.to(y.dtype), y, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
        dy = torch.where(y > 0, dyp, torch.zeros_like(dyp))

        # BN's dx from the two grid sums
        inv = torch.rsqrt(var + EPS)
        xhat = (xc.float() - mu[:, None, None]) * inv[:, None, None]
        dxc = (gamma * inv)[:, None, None] * (dy.float() - (sum_dy / n_count)[:, None, None]
                                              - xhat * (sum_dyx / n_count)[:, None, None])
        dxc = dxc.to(xc.dtype)

        need_w, need_gamma, need_beta, need_x = ctx.needs_input_grad
        dx, dw, _ = _conv_backward(
            dxc, x, w.to(x.dtype), None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
            [need_x, need_w, False])
        return (dw.to(w.dtype) if need_w else None,
                sum_dyx.to(gamma.dtype) if need_gamma else None,
                sum_dy.to(beta.dtype) if need_beta else None,
                dx if need_x else None)


def fused_stem_train(w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     x: torch.Tensor):
    """Train-mode stem with the grid-stats backward: ``(pooled, mu, var)``.
    ``w`` is the conv weight (64, c, 7, 7), ``x`` the NCHW images in the
    compute dtype."""
    out, mu, var = FusedStem.apply(w, gamma, beta, x)[:3]
    return out, mu, var
