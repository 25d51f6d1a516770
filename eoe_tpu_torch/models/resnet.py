"""WideResNet (ResNet-18-style with CBAM) for 224x224 inputs: the port of
eoe_tpu/models/resnet.py.

conv7x7 s2 -> BN -> ReLU -> maxpool3x3 s2 -> four stages of BasicBlocks
(64/128/256/512, stride 2 from stage 2), each with CBAM before the residual
add -> global average pool -> fc to rep_dim (default 256), plus an optional
one-neuron ``clf`` head. Kaiming-normal (fan_out) conv and fc kernels, BN eps
1e-5 and Flax momentum 0.9; the CBAM spatial BN's scale starts at zero.

In train mode the stem runs ``ops.stem.fused_stem_train`` (the grid-stats
backward), or its plain version ``plain_stem`` under autograd when
``EOE_TPU_FUSED_STEM=0`` (read at every forward): the same forward bit for
bit, so that the switch moves only the stem's own gradients (a last-bit
difference in the forward can flip the argmax of CBAM's max pools, which
moves gradients by percents). Either keeps the parameters of ``conv1`` and
``bn1`` and updates ``bn1``'s running averages from the batch statistics it
returns. NHWC RGB input of any spatial size, as in the JAX package.
"""

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.cbam import CBAM
from eoe_tpu_torch.models.layers import BatchNorm, Conv, ConvModel, Dense, kaiming_normal_fan_out
from eoe_tpu_torch.ops.stem import fused_stem_train, plain_stem
from eoe_tpu_torch.parallel.mesh import active_mesh


def _conv(cin, cout, k, stride, padding, dtype) -> Conv:
    return Conv(cin, cout, k, stride, padding, bias=False, kernel_init=kaiming_normal_fan_out,
                dtype=dtype)


def _bn(features, dtype) -> BatchNorm:
    return BatchNorm(features, eps=1e-5, momentum=0.9, dtype=dtype)


class BasicBlock(ConvModel):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_cbam: bool = True,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, dtype)
        self.bn1 = _bn(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype)
        self.bn2 = _bn(planes, dtype)
        if downsample:
            self.down_conv = _conv(inplanes, planes, 1, stride, 0, dtype)
            self.down_bn = _bn(planes, dtype)
        self.downsample = downsample
        self.cbam = CBAM(planes, 16, dtype=dtype) if use_cbam else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        if self.cbam is not None:
            return self.cbam.gate_tail(out, residual)
        return F.relu(out + residual)


class WideResNet(ConvModel):
    def __init__(self, rep_dim: int = 256, clf: bool = False,
                 layers: Sequence[int] = (2, 2, 2, 2), use_cbam: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.clf, self.dtype = clf, dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = _bn(64, dtype)
        self.block_names = []
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            stride = 1 if stage == 1 else 2
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or inplanes != planes)
                name = f"layer{stage}_block{b}"
                setattr(self, name, BasicBlock(inplanes, planes, s, use_cbam, down, dtype))
                self.block_names.append(name)
                inplanes = planes
        self.fc = Dense(inplanes, rep_dim, kernel_init=kaiming_normal_fan_out, dtype=dtype)
        if clf:
            self.linear = Dense(rep_dim, 1, kernel_init=kaiming_normal_fan_out, dtype=dtype)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def uses_fused_stem(self) -> bool:
        """Train mode, unless ``EOE_TPU_FUSED_STEM=0`` or a data mesh of
        several ranks is active (its global statistics take the plain stem)."""
        return self.training and os.environ.get("EOE_TPU_FUSED_STEM", "1") != "0" \
            and active_mesh() is None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.training:
            stem = fused_stem_train if self.uses_fused_stem() else plain_stem
            dt = self.dtype or torch.promote_types(x.dtype, torch.float32)
            x, mu, var = stem(self.conv1.weight, self.bn1.weight, self.bn1.bias, x.to(dt))
            self.bn1.update_averages(mu, var)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.fc(x.mean(dim=(2, 3)))
        if self.clf:
            x = self.linear(x)
        return x
