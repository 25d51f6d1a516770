"""CBAM attention, channel and spatial gates: the port of
eoe_tpu/models/cbam.py, on NCHW tensors.

Channel gate: a shared MLP (reduction 16, torch-linear init) over the avg-
and max-pooled features, summed, through a sigmoid. Spatial gate: a 7x7
conv (no bias, Flax's default lecun-normal init) over [channel max, channel
mean], then BN with a zero-initialised scale, eps 1e-5 and Flax momentum
0.99, no ReLU.

``CBAM.gate_tail`` is a BasicBlock's ``relu(cbam(x) + residual)``. For the
configuration WideResNet builds (avg and max pools, the spatial gate) on
fp32 or bf16 CUDA tensors it runs ``ops.cbam.gate_tail``, the gates and the
tail as CUDA kernels around this module's own MLP, conv and BN; otherwise,
and on the CPU, the plain composition of the modules below.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.layers import BatchNorm, Conv, ConvModel, Dense, torch_linear
from eoe_tpu_torch.ops import cbam as cbam_ops


class ChannelGate(ConvModel):
    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Sequence[str] = ("avg", "max"), dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, hidden = gate_channels, gate_channels // reduction_ratio
        self.pool_types = tuple(pool_types)
        self.mlp_hidden = Dense(c, hidden, kernel_init=torch_linear, bias_init=torch_linear,
                                dtype=dtype)
        self.mlp_out = Dense(hidden, c, kernel_init=torch_linear, bias_init=torch_linear,
                             dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att_sum = None
        for pool_type in self.pool_types:
            if pool_type == "avg":
                pooled = x.mean(dim=(2, 3))
            elif pool_type == "max":
                pooled = x.amax(dim=(2, 3))
            elif pool_type == "lse":
                pooled = torch.logsumexp(x.flatten(2), dim=2)
            else:
                raise NotImplementedError(pool_type)
            att = self.mlp_out(F.relu(self.mlp_hidden(pooled)))
            att_sum = att if att_sum is None else att_sum + att
        return x * torch.sigmoid(att_sum)[:, :, None, None]


class SpatialGate(ConvModel):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spatial_conv = Conv(2, 1, 7, padding=3, bias=False, dtype=dtype)
        self.spatial_bn = BatchNorm(1, eps=1e-5, momentum=0.99, scale_init=0.0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compress = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial_bn(self.spatial_conv(compress)))


class CBAM(ConvModel):
    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Sequence[str] = ("avg", "max"), no_spatial: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channel_gate = ChannelGate(gate_channels, reduction_ratio, pool_types, dtype)
        self.spatial_gate = None if no_spatial else SpatialGate(dtype)
        self.fusable = cbam_ops.fusable(gate_channels, pool_types, not no_spatial)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.channel_gate(x)
        return x if self.spatial_gate is None else self.spatial_gate(x)

    def gate_tail(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """``relu(self(x) + residual)``, a BasicBlock's tail: through the
        kernels where ``takes_kernels``, else the plain composition."""
        if self.takes_kernels(x, residual):
            return self.fused_gate_tail(x, residual)
        return F.relu(self(x) + residual)

    def takes_kernels(self, x: torch.Tensor, residual: torch.Tensor) -> bool:
        """A CUDA input and residual of one dtype, fp32 or bf16, that the
        module computes in (so that the plain composition's output has the
        input's dtype too)."""
        return (self.fusable and x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)
                and residual.dtype == x.dtype and self._compute_dtype(x) == x.dtype)

    def _compute_dtype(self, x: torch.Tensor) -> torch.dtype:
        return self.channel_gate.mlp_hidden.dtype or torch.promote_types(x.dtype, torch.float32)

    def fused_gate_tail(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """``ops.cbam.gate_tail`` around this module's MLP, conv and BN: the
        kernels on a CUDA tensor, their plain versions on a CPU one."""
        cg, sg = self.channel_gate, self.spatial_gate
        mlp = (cg.mlp_hidden.weight, cg.mlp_hidden.bias, cg.mlp_out.weight, cg.mlp_out.bias)
        return cbam_ops.gate_tail(x, residual, mlp, self._compute_dtype(x),
                                  lambda c: sg.spatial_bn(sg.spatial_conv(c)))
