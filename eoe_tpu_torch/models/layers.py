"""Layers shared by the conv models, with Flax semantics: the port of the
``nn.Conv`` / ``nn.Dense`` / ``nn.BatchNorm`` uses in eoe_tpu/models/.

Weights are kept in torch layouts (conv ``(out, in, kh, kw)``, dense
``(out, in)``); ``models.convert`` carries them to and from Flax's HWIO and
``(in, out)``. Activations are NCHW tensors, usually the channels-last view
``x.permute(0, 3, 1, 2)`` of the models' NHWC input, which cuDNN takes without
a copy.

``dtype`` is Flax's compute dtype: ``Conv`` and ``Dense`` cast input, weight
and bias to it (None: promote with the fp32 parameters), ``BatchNorm``
casts its normalised output to it. ``with_compute_dtype`` pushes a trainer's
compute dtype into a model built with ``dtype=None``, as the JAX trainer
clones such a model.

``BatchNorm`` is not ``nn.BatchNorm2d``: it computes the batch statistics
and normalises in fp32 before the cast, and updates the running averages
with the *biased* batch variance as ``momentum * old + (1 - momentum) * new``
(Flax's momentum, 0.9 where torch would say 0.1, and torch's modules would
take the unbiased variance). Inside ``collect_averages()`` it works
functionally, as the steps over stacked members (``torch.func``) need: in
train mode it writes nothing, the new averages go to the collector, keyed by
layer, and the step returns them as outputs; in eval mode it normalises with
plain ops (vmap does not batch cuDNN's batch norm on a channels-last view).
In train mode under a data mesh of several ranks (``parallel.mesh.active``,
which the trainer's step opens) it takes the statistics of the global batch,
as XLA's reduction over a sharded batch does.
"""

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eoe_tpu_torch.parallel.mesh import active_mesh, all_reduce_sum

# (tensor on the CPU, fan_in, fan_out, generator) -> None, filling the tensor
Init = Callable[[torch.Tensor, int, int, torch.Generator], None]

# torch nn.init.calculate_gain('leaky_relu') with the default slope 0.01
LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.01 ** 2))


def xavier_normal(gain: float = 1.0) -> Init:
    def init(t, fan_in, fan_out, g):
        t.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=g)
    return init


def kaiming_normal_fan_out(t, fan_in, fan_out, g):
    t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)


def torch_linear(t, fan_in, fan_out, g):
    """``nn.Linear``'s default: U(+-1/sqrt(fan_in)), for weight and bias."""
    bound = 1.0 / math.sqrt(fan_in)
    t.uniform_(-bound, bound, generator=g)


def lecun_normal(t, fan_in, fan_out, g):
    """Flax's default kernel init: a normal truncated at two standard
    deviations, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)


def zeros(t, fan_in, fan_out, g):
    t.zero_()


_COLLECTED: Optional[Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def collect_averages() -> Iterator[Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]]]:
    """Run ``BatchNorm`` layers functionally: in train mode they hand their
    new running averages to the yielded ``{layer: (mean, var)}`` instead of
    writing them into their buffers."""
    global _COLLECTED
    outer, _COLLECTED = _COLLECTED, {}
    try:
        yield _COLLECTED
    finally:
        _COLLECTED = outer


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, torch.float32)


class _Weighted(nn.Module):
    """A layer with a kernel and an optional bias, initialised on the CPU
    from a generator by ``reset_layer``."""

    def __init__(self, shape, fan_in: int, fan_out: int, bias: bool, kernel_init: Init,
                 bias_init: Init, dtype: Optional[torch.dtype]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        self.fan_in, self.fan_out = fan_in, fan_out
        self.kernel_init, self.bias_init = kernel_init, bias_init
        self.dtype = dtype

    @torch.no_grad()
    def reset_layer(self, g: torch.Generator):
        for p, init in ((self.weight, self.kernel_init), (self.bias, self.bias_init)):
            if p is not None:
                cpu = torch.empty(p.shape)
                init(cpu, self.fan_in, self.fan_out, g)
                p.copy_(cpu)

    def _cast(self, x):
        dt = _compute_dtype(self.dtype, x)
        return (x.to(dt), self.weight.to(dt),
                None if self.bias is None else self.bias.to(dt))


class Conv(_Weighted):
    """``nn.Conv`` with square kernels and symmetric integer padding. Flax's
    stride-1 ``nn.ConvTranspose`` (``transpose_kernel=False``) with the same
    padding is this layer too: a cross-correlation with the unflipped
    kernel."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, kernel_init: Init = lecun_normal, bias_init: Init = zeros,
                 dtype: Optional[torch.dtype] = None):
        super().__init__((cout, cin, k, k), cin * k * k, cout * k * k, bias, kernel_init,
                         bias_init, dtype)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x, w, b = self._cast(x)
        return F.conv2d(x, w, b, self.stride, self.padding)


class Dense(_Weighted):
    def __init__(self, cin: int, cout: int, bias: bool = True, kernel_init: Init = lecun_normal,
                 bias_init: Init = zeros, dtype: Optional[torch.dtype] = None):
        super().__init__((cout, cin), cin, cout, bias, kernel_init, bias_init, dtype)

    def forward(self, x):
        return F.linear(*self._cast(x))


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over dim 1 of an ``(n, c)`` or NCHW tensor;
    train mode (``module.training``) normalises with the batch statistics
    and updates the running averages, eval mode uses the averages. The work
    is torch's own batch norm (``native_batch_norm``, which computes in fp32
    whatever the input dtype), called without running averages; the batch
    variance it normalised with (biased) comes back from its saved inverse
    std, and the averages move by Flax's rule."""

    def __init__(self, features: int, eps: float, momentum: float = 0.9, affine: bool = True,
                 scale_init: float = 1.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.momentum, self.scale_init, self.dtype = eps, momentum, scale_init, dtype
        self.weight = nn.Parameter(torch.empty(features)) if affine else None
        self.bias = nn.Parameter(torch.empty(features)) if affine else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.reset_layer(None)

    @torch.no_grad()
    def reset_layer(self, g):
        if self.weight is not None:
            self.weight.fill_(self.scale_init)
            self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    @torch.no_grad()
    def update_averages(self, mu: torch.Tensor, var: torch.Tensor):
        m = self.momentum
        mean = m * self.running_mean + (1 - m) * mu
        var = m * self.running_var + (1 - m) * var
        if _COLLECTED is not None:
            _COLLECTED[self] = (mean, var)
        else:
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)

    def _normalise(self, x):
        """Eval mode's normalisation with the running averages, as plain ops
        in fp32."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x.float() - self.running_mean.reshape(shape)) \
            * torch.rsqrt(self.running_var.reshape(shape) + self.eps)
        if self.weight is not None:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y

    def _global(self, x, mesh):
        """Train mode under a data mesh of several ranks: the statistics of
        the global batch, as Flax's ``use_fast_variance`` takes them (var =
        E[x^2] - E[x]^2 in fp32), from the ranks' per-channel sums, sums of
        squares and counts (``all_reduce_sum``, whose backward sums the
        ranks' gradients)."""
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // max(c, 1))
        tot = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]), mesh)
        mu = tot[:c] / tot[-1]
        var = (tot[c:2 * c] / tot[-1] - mu * mu).clamp_min(0.0)
        y = (xf - mu.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(shape)
        if self.weight is not None:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        self.update_averages(mu.detach(), var.detach())
        return y

    def forward(self, x):
        # Flax's output dtype; normalising in the wider of it and the input's
        out = self.dtype or (torch.promote_types(x.dtype, torch.float32)
                             if self.weight is not None else x.dtype)
        x = x.to(torch.promote_types(x.dtype, out))
        if self.training and _COLLECTED is None and active_mesh() is not None:
            return self._global(x, active_mesh()).to(out)
        if self.training:
            if _COLLECTED is not None:
                # the functional step: under vmap, the batched backward of a
                # bf16 input with fp32 weights fails on mixed dtypes, so the
                # statistics and the normalisation take the input in fp32
                x = x.float()
            if not x.is_cuda:
                # torch's channels-last batch norm on the CPU loses precision:
                # at 16K values a channel its gradients were 0.6% of their
                # scale off float64, the contiguous kernel's 4e-6
                x = x.contiguous()
            y, mu, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                    0.0, self.eps)
            self.update_averages(mu.detach(), invstd.detach().pow(-2) - self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps) if _COLLECTED is None else self._normalise(x)
        return y.to(out)


class ConvModel(nn.Module):
    """Base of the conv models: ``reset_parameters(g)`` draws every layer's
    weights anew on the CPU from ``g``, in registration order."""

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        for m in self.modules():
            if hasattr(m, "reset_layer"):
                m.reset_layer(g)


def with_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``dtype`` on every layer of a model built with ``dtype=None``
    (the JAX trainer's ``model.clone(dtype=compute_dtype)``); other models
    are returned as they are."""
    if getattr(model, "dtype", False) is None and dtype != torch.float32:
        for m in model.modules():
            if hasattr(m, "dtype") and m.dtype is None:
                m.dtype = dtype
    return model
