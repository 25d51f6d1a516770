"""CBAM attention, channel and spatial gates: the port of
eoe_tpu/models/cbam.py, on NCHW tensors.

Channel gate: a shared MLP (reduction 16, torch-linear init) over the avg-
and max-pooled features, summed, through a sigmoid. Spatial gate: a 7x7
conv (no bias, Flax's default lecun-normal init) over [channel max, channel
mean], then BN with a zero-initialised scale, eps 1e-5 and Flax momentum
0.99, no ReLU.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.layers import BatchNorm, Conv, ConvModel, Dense, torch_linear


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
        self.reset_parameters(torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.channel_gate(x)
        return x if self.spatial_gate is None else self.spatial_gate(x)
