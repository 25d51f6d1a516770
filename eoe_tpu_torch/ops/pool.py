"""Max pooling with an explicit per-tap backward: the port of
eoe_tpu/ops/pool.py, kept, as there, as the record of a measured negative
result and wired into no model.

The JAX package wrote this backward to avoid XLA's select-and-scatter on
the TPU and lost (its docstring has the TPU numbers). Here it is a
``torch.autograd.Function`` on NCHW tensors, the port's layout: the forward
is the ordinary max pool over the input padded with -inf (the smallest
integer for integer tensors), and the backward routes each output cell's
gradient to the first (row-major) tap of its window that holds the window's
maximum, torch's ``MaxPool2d`` routing, as k*k strided masked adds into a
padded buffer (in fp32 for half-precision gradients, rounded once).
``chip_smoke.py`` times it on the card against ``F.max_pool2d``'s forward
and gradient.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def _pad_value(dtype: torch.dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _taps(xp: torch.Tensor, window, strides, out_hw):
    """(di, dj, the (n, c, oh, ow) view of ``xp`` at tap (di, dj))."""
    (kh, kw), (sh, sw), (oh, ow) = window, strides, out_hw
    for di in range(kh):
        for dj in range(kw):
            yield di, dj, xp[:, :, di:di + sh * (oh - 1) + 1:sh, dj:dj + sw * (ow - 1) + 1:sw]


def _reduce_max(x: torch.Tensor, window, strides, padding: Padding):
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x, (pl, pr, pt, pb), value=_pad_value(x.dtype)) if any(padding[0] + padding[1]) \
        else x
    if x.dtype.is_floating_point:
        return xp, F.max_pool2d(xp, window, strides)
    oh = (xp.shape[2] - window[0]) // strides[0] + 1
    ow = (xp.shape[3] - window[1]) // strides[1] + 1
    y = None
    for _, _, tap in _taps(xp, window, strides, (oh, ow)):
        y = tap.clone() if y is None else torch.maximum(y, tap)
    return xp, y


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        xp, y = _reduce_max(x, window, strides, padding)
        ctx.save_for_backward(xp, y)
        ctx.geometry = (window, strides, padding, x.shape)
        return y

    @staticmethod
    def backward(ctx, g):
        xp, y = ctx.saved_tensors
        window, strides, ((pt, _), (pl, _)), shape = ctx.geometry
        # half-precision gradients sum in fp32 and round once, as torch's own
        # max-pool backward does
        acc = torch.promote_types(g.dtype, torch.float32)
        buf = torch.zeros(xp.shape, dtype=acc, device=g.device)
        seen = torch.zeros(y.shape, dtype=torch.bool, device=g.device)
        sh, sw = strides
        oh, ow = y.shape[2], y.shape[3]
        for di, dj, tap in _taps(xp, window, strides, (oh, ow)):
            hit = (tap == y) & ~seen
            seen |= hit
            buf[:, :, di:di + sh * (oh - 1) + 1:sh, dj:dj + sw * (ow - 1) + 1:sw] += \
                torch.where(hit, g, torch.zeros((), dtype=g.dtype, device=g.device)).to(acc)
        return buf[:, :, pt:pt + shape[2], pl:pl + shape[3]].to(g.dtype), None, None, None


def max_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
             padding: Padding = ((0, 0), (0, 0))) -> torch.Tensor:
    """NCHW max pooling over ``window`` with ``strides`` and explicit
    (top, bottom), (left, right) padding; the JAX function's results (on
    NHWC there). Ties route the full gradient to the first (row-major)
    maximal tap, as ``torch.nn.MaxPool2d`` does."""
    return _MaxPool.apply(x, tuple(window), tuple(strides),
                          tuple(tuple(p) for p in padding))


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """The ResNet stem pool (torch ``MaxPool2d(3, 2, 1)``)."""
    return max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))


def max_pool_2x2_s2(x: torch.Tensor) -> torch.Tensor:
    """The CNN28/32 pool (torch ``MaxPool2d(2, 2)``)."""
    return max_pool(x, (2, 2), (2, 2))
