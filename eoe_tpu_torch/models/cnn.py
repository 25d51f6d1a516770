"""Small conv backbones for 28x28 grayscale and 32x32 RGB images: the port
of eoe_tpu/models/cnn.py.

CNN28: 2 conv -> fc 64 -> rep 32; CNN32: 3 conv -> fc 512 -> rep 256. BN with
eps 1e-4 and its affine tied to ``bias``, leaky ReLU, 2x2 max pools, an
optional one-neuron ``clf`` head for BCE and focal. Xavier-normal conv and fc
kernels with the leaky-ReLU gain (fc2 gain 1), torch-linear init for the
head. NHWC input, as in the JAX package; the flatten before ``fc1`` runs in
(h, w, c) order, as the JAX model's, so ``fc1``'s weight carries across
without a permutation.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.layers import (
    LEAKY_GAIN, BatchNorm, Conv, ConvModel, Dense, torch_linear, xavier_normal)


def _bn(features: int, affine: bool, dtype) -> BatchNorm:
    return BatchNorm(features, eps=1e-4, momentum=0.9, affine=affine, dtype=dtype)


def _conv5(cin: int, cout: int, bias: bool, dtype) -> Conv:
    return Conv(cin, cout, 5, padding=2, bias=bias, kernel_init=xavier_normal(LEAKY_GAIN),
                dtype=dtype)


def _block(x, conv, bn):
    return F.max_pool2d(F.leaky_relu(bn(conv(x))), 2)


class _CNN(ConvModel):
    """Conv stages, the flatten, fc1 -> BN -> leaky ReLU -> fc2 (-> head)."""

    HW, CHANNELS, FC = 32, (3, 32, 64, 128), 512

    def __init__(self, rep_dim: int, bias: bool, clf: bool, in_channels: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.clf, self.dtype, self.in_channels = clf, dtype, in_channels
        chans = (in_channels,) + self.CHANNELS[1:]
        for i in range(1, len(chans)):
            setattr(self, f"conv{i}", _conv5(chans[i - 1], chans[i], bias, dtype))
            setattr(self, f"bn2d{i}", _bn(chans[i], bias, dtype))
        self.n_stages = len(chans) - 1
        side = self.HW >> self.n_stages
        self.fc1 = Dense(side * side * chans[-1], self.FC, bias,
                         kernel_init=xavier_normal(LEAKY_GAIN), dtype=dtype)
        self.bn1d1 = _bn(self.FC, bias, dtype)
        self.fc2 = Dense(self.FC, rep_dim, bias, kernel_init=xavier_normal(), dtype=dtype)
        if clf:  # built without the compute dtype in the JAX model: it promotes to fp32
            self.linear = Dense(rep_dim, 1, kernel_init=torch_linear, bias_init=torch_linear,
                                dtype=torch.float32)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1, self.HW, self.HW, self.in_channels).permute(0, 3, 1, 2)
        for i in range(1, self.n_stages + 1):
            x = _block(x, getattr(self, f"conv{i}"), getattr(self, f"bn2d{i}"))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) order
        x = F.leaky_relu(self.bn1d1(self.fc1(x)))
        x = self.fc2(x)
        if self.clf:
            x = self.linear(x)
        return x


class CNN28(_CNN):
    """2-conv net for 28x28x1 inputs -> rep_dim features (default 32)."""

    HW, CHANNELS, FC = 28, (1, 16, 32), 64

    def __init__(self, rep_dim: int = 32, bias: bool = True, clf: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(rep_dim, bias, clf, 1, dtype)


class CNN32(_CNN):
    """3-conv net for 32x32x3 (or x1) inputs -> rep_dim features (default 256)."""

    def __init__(self, rep_dim: int = 256, bias: bool = True, clf: bool = False,
                 grayscale: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(rep_dim, bias, clf, 1 if grayscale else 3, dtype)
