"""Plain PyTorch WideResNet + CBAM of the EOE reference (Liznerski et al.,
TMLR 2022, ``src/eoe/models/resnet.py``), with the HSC loss and score.

A ResNet-18 of BasicBlocks: conv 7x7 stride 2 (padding 3), batch norm,
ReLU, max pool 3x3 stride 2 (padding 1); four stages of two blocks at
64/128/256/512 channels (stride 2 from the second stage, a 1x1 convolution
and batch norm on the shortcut where the shape changes), each block's
second batch norm followed by CBAM (Woo et al. 2018: a channel gate, a
shared two-layer MLP of reduction 16 over the average- and max-pooled
features, summed, through a sigmoid; then a spatial gate, a 7x7 convolution
without bias over the channel max and mean, batch norm, sigmoid) before the
residual sum; global average pool and a dense layer to ``rep_dim``.

Batch norm in training normalises with the batch's mean and biased
variance, eps 1e-5, written out. Weights in torch layouts (conv ``(out, in,
kh, kw)``, dense ``(out, in)``), images NHWC. Every convolution and dense
layer goes through a ``precision.Precision``.
"""

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]
EPS = 1e-5


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, in channels, out channels, stride, shortcut projection)."""
    out, cin = [], cfg["stem_width"]
    for stage, (planes, n) in enumerate(zip(cfg["stage_widths"], cfg["blocks_per_stage"]),
                                        start=1):
        for b in range(n):
            stride = (1 if stage == 1 else 2) if b == 0 else 1
            out.append((f"layer{stage}_block{b}", cin, planes, stride,
                        b == 0 and (stride != 1 or cin != planes)))
            cin = planes
    return out


def param_specs(cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, how it is drawn), as ``clip_vit.param_specs``; the
    batch-norm averages ("const") are buffers, not parameters."""
    out = {}

    def conv(name, cout, cin, k):
        out[name + ".weight"] = ((cout, cin, k, k), ("normal", (2.0 / (cout * k * k)) ** 0.5))

    def bn(name, c):
        out[name + ".weight"] = ((c,), ("ones", 0.1))
        out[name + ".bias"] = ((c,), ("normal", 0.1))
        out[name + ".running_mean"] = ((c,), ("const", 0.0))
        out[name + ".running_var"] = ((c,), ("const", 1.0))

    def dense(name, cout, cin, std):
        out[name + ".weight"] = ((cout, cin), ("normal", std))
        out[name + ".bias"] = ((cout,), ("normal", 0.02))

    conv("conv1", cfg["stem_width"], 3, 7)
    bn("bn1", cfg["stem_width"])
    r = cfg["cbam_reduction"]
    for name, cin, cout, _stride, down in blocks(cfg):
        conv(f"{name}.conv1", cout, cin, 3)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        bn(f"{name}.bn2", cout)
        if down:
            conv(f"{name}.down_conv", cout, cin, 1)
            bn(f"{name}.down_bn", cout)
        g = f"{name}.cbam."
        dense(g + "channel_gate.mlp_hidden", cout // r, cout, cout ** -0.5)
        dense(g + "channel_gate.mlp_out", cout, cout // r, (cout // r) ** -0.5)
        out[g + "spatial_gate.spatial_conv.weight"] = ((1, 2, 7, 7), ("normal", 98 ** -0.5))
        bn(g + "spatial_gate.spatial_bn", 1)
    c = cfg["stage_widths"][-1]
    # a tenth of the Kaiming scale: features of norm about 1, as HSC trains
    # normal samples towards the origin (the scores stay off their ceiling)
    dense("fc", cfg["rep_dim"], c, 0.1 * (2.0 / cfg["rep_dim"]) ** 0.5)
    return out


def trainable(name: str) -> bool:
    return not (name.endswith(".running_mean") or name.endswith(".running_var"))


def batch_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mu).square().mean(dim=(0, 2, 3), keepdim=True)
    y = (x - mu) * torch.rsqrt(var + EPS)
    return y * p[name + ".weight"].reshape(1, -1, 1, 1) + p[name + ".bias"].reshape(1, -1, 1, 1)


def cbam(x: torch.Tensor, p: Params, g: str, P: Precision) -> torch.Tensor:
    def mlp(z):
        h = torch.relu(P.linear(z, p[g + "channel_gate.mlp_hidden.weight"],
                                p[g + "channel_gate.mlp_hidden.bias"]))
        return P.linear(h, p[g + "channel_gate.mlp_out.weight"], p[g + "channel_gate.mlp_out.bias"])

    att = mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3)))
    x = x * torch.sigmoid(att)[:, :, None, None]
    comp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
    s = batch_norm(P.conv(comp, p[g + "spatial_gate.spatial_conv.weight"], 1, 3), p,
                   g + "spatial_gate.spatial_bn")
    return x * torch.sigmoid(s)


def forward(p: Params, images: torch.Tensor, cfg: dict, P: Precision) -> torch.Tensor:
    """(n, h, w, 3) float images -> (n, rep_dim), batch norm in training mode."""
    x = images.float().permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(P.conv(x, p["conv1.weight"], 2, 3), p, "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _cin, _cout, stride, down in blocks(cfg):
        out = torch.relu(batch_norm(P.conv(x, p[f"{name}.conv1.weight"], stride, 1), p,
                                    f"{name}.bn1"))
        out = batch_norm(P.conv(out, p[f"{name}.conv2.weight"], 1, 1), p, f"{name}.bn2")
        res = batch_norm(P.conv(x, p[f"{name}.down_conv.weight"], stride, 0), p,
                         f"{name}.down_bn") if down else x
        x = torch.relu(cbam(out, p, f"{name}.cbam.", P) + res)
    return P.linear(x.mean(dim=(2, 3)), p["fc.weight"], p["fc.bias"])


def loss_terms(feats: torch.Tensor, labels: torch.Tensor, centre=None) -> torch.Tensor:
    """HSC: normal samples (label 0) take the pseudo-Huber distance
    sqrt(|f|^2 + 1) - 1, anomalous ones -log(1 - exp(-distance))."""
    d = torch.sqrt(feats.square().sum(dim=-1) + 1.0) - 1.0
    return torch.where(labels == 0, d, -torch.log(1.0 - torch.exp(-d) + 1e-9))


def score(feats: torch.Tensor, centre=None) -> torch.Tensor:
    return 1.0 - torch.exp(-(torch.sqrt(feats.square().sum(dim=-1) + 1.0) - 1.0))
