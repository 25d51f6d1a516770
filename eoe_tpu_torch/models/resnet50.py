"""The torchvision wide ResNet-50 trunk with a fresh head: the port of
eoe_tpu/models/resnet50.py.

torchvision's ``wide_resnet50_2`` with its fc replaced by a fresh
``rep_dim`` head (and an optional one-neuron ``clf``): a 7x7 stride-2 stem,
BN, ReLU and a 3x3 stride-2 max pool, then stages of torchvision
Bottlenecks (the stride on the first block's 3x3 conv, a downsample on the
first block of every stage, the bottleneck ``width_factor`` times the base
width), global average pooling and the head. Kaiming-normal (fan_out)
convolutions, torch-linear head, BN eps 1e-5 and Flax momentum 0.9. NHWC
input, as in the JAX package. Like the JAX model it has no compute dtype:
its layers promote a half-precision input to fp32 with their parameters.

Nothing is downloaded: ImageNet weights come from a torchvision state
dict the user supplies (``load_torchvision_state_dict``,
``load_pretrained``). The port keeps torch's layouts, so the weights copy
across under the port's names (``layerS.B`` -> ``layerS_B``,
``downsample.0`` / ``.1`` -> ``down_conv`` / ``down_bn``); torch's
``num_batches_tracked`` counters and the torchvision fc are dropped.
"""

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from eoe_tpu_torch.models.layers import (
    BatchNorm, Conv, ConvModel, Dense, kaiming_normal_fan_out, torch_linear)


def _conv(cin, cout, k, stride) -> Conv:
    return Conv(cin, cout, k, stride, k // 2, bias=False, kernel_init=kaiming_normal_fan_out)


def _bn(features) -> BatchNorm:
    return BatchNorm(features, eps=1e-5, momentum=0.9)


class TorchBottleneck(ConvModel):
    """torchvision's Bottleneck: 1x1, 3x3 (with the stride), 1x1 expanding,
    each with BN; a 1x1 strided downsample on the identity."""

    def __init__(self, inplanes: int, planes: int, out_planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(inplanes, planes, 1, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out_planes, 1, 1), _bn(out_planes)
        self.downsample = downsample
        if downsample:
            self.down_conv, self.down_bn = _conv(inplanes, out_planes, 1, stride), _bn(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class WideResNet50Pretrained(ConvModel):
    """wide_resnet50_2 trunk + fresh ``rep_dim`` head (+ optional 1-neuron
    ``clf``)."""

    def __init__(self, rep_dim: int = 256, clf: bool = False, width_factor: int = 2,
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.clf = clf
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), _bn(64)
        self.block_names = []
        inplanes = 64
        for stage, blocks in enumerate(layers, start=1):
            base = 64 * 2 ** (stage - 1)
            for b in range(blocks):
                name = f"layer{stage}_{b}"
                setattr(self, name, TorchBottleneck(
                    inplanes, base * width_factor, base * 4,
                    2 if stage > 1 and b == 0 else 1, b == 0))
                self.block_names.append(name)
                inplanes = base * 4
        self.fc = Dense(inplanes, rep_dim, kernel_init=torch_linear, bias_init=torch_linear)
        if clf:
            self.linear = Dense(rep_dim, 1, kernel_init=torch_linear, bias_init=torch_linear)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.fc(x.mean(dim=(2, 3)))
        if self.clf:
            x = self.linear(x)
        return x


BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def bottleneck_keys(layers: Sequence[int], src: str = "", dst: str = "") -> Dict[str, str]:
    """Torch key -> port key of bottleneck stages of ``layers`` blocks each,
    below the prefixes ``src`` and ``dst``: ``layerS.B`` -> ``layerS_B``,
    ``downsample.0/.1`` -> ``down_conv``/``down_bn``, conv1-3 and bn1-3 with
    their batch-norm leaves. The torchvision trunk and CLIP's ModifiedResNet
    share it."""
    keys = {}
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            s, d = f"{src}layer{stage}.{b}", f"{dst}layer{stage}_{b}"
            for i in (1, 2, 3):
                keys[f"{s}.conv{i}.weight"] = f"{d}.conv{i}.weight"
                keys.update({f"{s}.bn{i}.{a}": f"{d}.bn{i}.{a}" for a in BN_KEYS})
            if b == 0:   # the first block of a stage changes width or stride
                keys[f"{s}.downsample.0.weight"] = f"{d}.down_conv.weight"
                keys.update({f"{s}.downsample.1.{a}": f"{d}.down_bn.{a}" for a in BN_KEYS})
    return keys


def trunk_keys(layers: Sequence[int]) -> Dict[str, str]:
    """torchvision key -> port key for the trunk of ``layers`` stages."""
    keys = {"conv1.weight": "conv1.weight"}
    keys.update({f"bn1.{a}": f"bn1.{a}" for a in BN_KEYS})
    keys.update(bottleneck_keys(layers))
    return keys


def load_torchvision_state_dict(sd: Dict[str, torch.Tensor],
                                layers: Tuple[int, ...] = (3, 4, 6, 3)
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision wide_resnet50_2 state dict -> the trunk's entries of
    the port's ``state_dict`` (fp32, on the CPU); the head is not converted
    (the reference replaces it too)."""
    return {port: torch.as_tensor(sd[k]).detach().cpu().float().contiguous()
            for k, port in trunk_keys(layers).items()}


def load_pretrained(path: str, rep_dim: int = 256, clf: bool = False
                    ) -> WideResNet50Pretrained:
    """The model with the trunk of a torchvision checkpoint file and a fresh
    head."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = WideResNet50Pretrained(rep_dim=rep_dim, clf=clf)
    model.load_state_dict(load_torchvision_state_dict(sd), strict=False)
    return model
