"""Convolutional autoencoder for 32x32 RGB images, the model of the ``ae``
objective: the port of eoe_tpu/models/ae.py.

A CNN32 encoder to a 128-wide latent, BN, the latent reshaped to NHWC
(4, 4, rep_dim / 16) as in the JAX model, then four 5x5 "deconvs" with x2
nearest upsampling between them and a sigmoid. Flax's stride-1
``nn.ConvTranspose`` with padding 2 does not flip its kernel, so each deconv
is a plain 5x5 cross-correlation with padding 2 (``layers.Conv``).
"""

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.cnn import CNN32, _bn
from eoe_tpu_torch.models.layers import LEAKY_GAIN, Conv, ConvModel, xavier_normal


def _deconv(cin: int, cout: int, bias: bool) -> Conv:
    return Conv(cin, cout, 5, padding=2, bias=bias, kernel_init=xavier_normal(LEAKY_GAIN))


class AE32(ConvModel):
    def __init__(self, bias: bool = True, rep_dim: int = 128):
        super().__init__()
        self.rep_dim = rep_dim
        self.encoder = CNN32(rep_dim=rep_dim, bias=bias)
        self.bn1d = _bn(rep_dim, bias, None)
        self.deconv1 = _deconv(rep_dim // 16, 128, bias)
        self.bn2d4 = _bn(128, bias, None)
        self.deconv2 = _deconv(128, 64, bias)
        self.bn2d5 = _bn(64, bias, None)
        self.deconv3 = _deconv(64, 32, bias)
        self.bn2d6 = _bn(32, bias, None)
        self.deconv4 = _deconv(32, 3, bias)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.bn1d(self.encoder(x))
        x = F.leaky_relu(z.reshape(z.shape[0], 4, 4, self.rep_dim // 16).permute(0, 3, 1, 2))
        for deconv, bn in ((self.deconv1, self.bn2d4), (self.deconv2, self.bn2d5),
                           (self.deconv3, self.bn2d6)):
            x = F.interpolate(F.leaky_relu(bn(deconv(x))), scale_factor=2, mode="nearest")
        return torch.sigmoid(self.deconv4(x)).permute(0, 2, 3, 1)   # NHWC, as the input
