"""CLIP (the ViT and ModifiedResNet variants) in PyTorch: the port of
eoe_tpu/models/clip/model.py.

Same architecture and numerics as the Flax model: QuickGELU MLPs, pre-LN
residual blocks, LayerNorm computed in fp32, causal text encoder with EOT
pooling by argmax over token ids, class-token pooling and projection for the
ViT; for the ResNets a 3-conv stem, blur-pooled Bottlenecks and
``AttentionPool2d``. Images are NHWC, as in the JAX package; the ResNet tower
takes their channels-last NCHW view for its convolutions.

Parameters stay fp32; ``dtype`` is the compute dtype. Every dense layer casts
its input, weight and bias to ``dtype`` explicitly, as Flax ``nn.Dense(dtype=)``
does (no autocast). Attention runs through the fused-QKV CUDA kernels when
they apply (``fused_qkv_ok``: on the card) and the mask is none or causal,
forward and, in training, backward (``fused_qkv_attention`` is an autograd
Function); else, as on the CPU, through ``default_attention``.
``qkv_attention`` replaces the kernels by another function of the same
signature, e.g. their plain versions ``fused_qkv_attention_ref``.
``attention_fn`` is the JAX model's hook: when set, every block splits q, k
and v into ``(n, heads, s, d)``, calls ``attention_fn(q, k, v, mask)`` (e.g.
``flash_attention``) and skips the fused route; the text tower passes its
additive causal mask. A model takes one of the two hooks, not both.

The ResNet tower's batch norm is ``models.layers.BatchNorm`` (Flax's:
momentum 0.9, the biased batch variance into the averages), in train mode
with the module (``model.train()``), as the JAX tower with ``train=True``
and ``mutable=["batch_stats"]``. Its ``AttentionPool2d`` is plain attention
(``default_attention``), as in JAX: no kernel of the repository.
"""

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from eoe_tpu_torch.models.layers import BatchNorm, Conv
from eoe_tpu_torch.ops.attention import default_attention, fused_qkv_attention, fused_qkv_ok

QkvAttention = Callable[[torch.Tensor, int, bool], torch.Tensor]
AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                       torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: Union[int, Tuple[int, int, int, int]] = 12
    vision_width: int = 768
    vision_patch_size: Optional[int] = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # explicit head count for non-standard widths (default: width // 64)
    vision_heads_override: Optional[int] = None

    @property
    def is_vit(self) -> bool:
        return not isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self) -> int:
        if self.vision_heads_override is not None:
            return self.vision_heads_override
        return max(1, self.vision_width // 64 if self.is_vit
                   else self.vision_width * 32 // 64)


VIT_B32 = ClipConfig()
RN50 = ClipConfig(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
                  vision_patch_size=None)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax's lecun_normal: a normal truncated at two standard deviations,
    # rescaled to variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32 whatever the activation dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return out.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Joint ``qkv`` in-projection, separate ``attn_out`` out-projection."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 qkv_attention: Optional[QkvAttention] = None,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        if qkv_attention is not None and attention_fn is not None:
            raise ValueError("pass qkv_attention or attention_fn, not both")
        self.heads = heads
        self.dtype = dtype
        self.qkv_attention = qkv_attention
        self.attention_fn = attention_fn
        self.qkv = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        n, s, d = x.shape
        hd = d // self.heads
        qkv = _dense(x, self.qkv, self.dtype)
        if self.attention_fn is None and (mask is None or causal):
            if self.qkv_attention is not None:
                return _dense(self.qkv_attention(qkv, self.heads, causal), self.attn_out, self.dtype)
            if fused_qkv_ok(n, s, self.heads, hd, qkv):
                return _dense(fused_qkv_attention(qkv, self.heads, causal), self.attn_out, self.dtype)
        q, k, v = (t.reshape(n, s, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = (self.attention_fn or default_attention)(q, k, v, mask)
        return _dense(attn.transpose(1, 2).reshape(n, s, d), self.attn_out, self.dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 qkv_attention: Optional[QkvAttention] = None,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNormF32(width)
        self.attn = MultiHeadAttention(width, heads, dtype, qkv_attention, attention_fn)
        self.ln_2 = LayerNormF32(width)
        self.mlp_up = nn.Linear(width, 4 * width)
        self.mlp_down = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask, causal)
        h = _dense(self.ln_2(x), self.mlp_up, self.dtype)
        return x + _dense(quick_gelu(h), self.mlp_down, self.dtype)


class TransformerStack(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype,
                 qkv_attention: Optional[QkvAttention] = None,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, qkv_attention, attention_fn)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, mask, causal)
        return x


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as a patchify GEMM. The weight keeps
    the HWIO ``(p, p, c, width)`` shape of the Flax parameter."""

    def __init__(self, width: int, patch: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(patch, patch, channels, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        n, h, w, c = x.shape
        x = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, h // p, w // p, p * p * c).to(self.dtype)
        return x @ self.kernel.reshape(p * p * c, -1).to(self.dtype)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig, dtype: torch.dtype,
                 qkv_attention: Optional[QkvAttention] = None,
                 attention_fn: Optional[AttentionFn] = None):
        super().__init__()
        w = cfg.vision_width
        grid = cfg.image_resolution // cfg.vision_patch_size
        self.patch_embed = PatchEmbed(w, cfg.vision_patch_size, 3, dtype)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w))
        self.ln_pre = LayerNormF32(w)
        self.transformer = TransformerStack(w, cfg.vision_layers, cfg.vision_heads, dtype,
                                            qkv_attention, attention_fn)
        self.ln_post = LayerNormF32(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)  # x: NHWC in the CLIP-normalized range
        n, gh, gw, w = x.shape
        x = x.reshape(n, gh * gw, w)
        cls_tok = self.class_embedding.to(x.dtype).expand(n, 1, w)
        x = torch.cat([cls_tok, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(x.dtype)


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=1e-5, momentum=0.9)


def _conv(cin: int, cout: int, k: int, dtype: torch.dtype, stride: int = 1) -> Conv:
    return Conv(cin, cout, k, stride, padding=k // 2, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    """Blur-pooled bottleneck: a stride above 1 average-pools before the
    expanding ``conv3``, and before ``down_conv`` on the identity."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1, dtype), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, dtype), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1, dtype), _bn(planes * 4)
        self.downsample = stride > 1 or inplanes != planes * 4
        if self.downsample:
            self.down_conv, self.down_bn = _conv(inplanes, planes * 4, 1, dtype), _bn(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.down_bn(self.down_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Attention of the mean token over the h-major flattened grid (with the
    mean token prepended and the positional embedding added), with separate
    q, k and v projections; the query is the mean token alone."""

    def __init__(self, grid: int, embed_dim: int, heads: int, output_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(2).transpose(1, 2)                        # (n, h*w, c), h-major
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        n, s, c = x.shape
        hd = c // self.heads
        q = _dense(x[:, :1], self.q_proj, self.dtype).reshape(n, 1, self.heads, hd)
        k = _dense(x, self.k_proj, self.dtype).reshape(n, s, self.heads, hd)
        v = _dense(x, self.v_proj, self.dtype).reshape(n, s, self.heads, hd)
        out = default_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None)
        return _dense(out.transpose(1, 2).reshape(n, c), self.c_proj, self.dtype)


class ModifiedResNet(nn.Module):
    """3-conv stem (the first with stride 2) and a 2x2 average pool, four
    stages of ``Bottleneck`` (stride 2 at the first block of stages 2-4),
    then ``AttentionPool2d``. NHWC input."""

    def __init__(self, cfg: ClipConfig, dtype: torch.dtype):
        super().__init__()
        width = cfg.vision_width
        self.conv1, self.bn1 = _conv(3, width // 2, 3, dtype, stride=2), _bn(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3, dtype), _bn(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3, dtype), _bn(width)
        self.block_names = []
        inplanes = width
        for stage, blocks in enumerate(cfg.vision_layers, start=1):
            planes = width * 2 ** (stage - 1)
            for b in range(blocks):
                stride = 2 if stage > 1 and b == 0 else 1
                name = f"layer{stage}_{b}"
                setattr(self, name, Bottleneck(inplanes, planes, stride, dtype))
                self.block_names.append(name)
                inplanes = planes * Bottleneck.expansion
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, width * 32, cfg.vision_heads,
                                        cfg.embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.attnpool(x)


class CLIP(nn.Module):
    """Full CLIP with ``encode_image`` / ``encode_text`` / ``contrastive``;
    ``forward(images)`` returns image features only, as the JAX model does.

    Built with random weights from ``generator`` (default: seed 0) following
    the Flax initialisers' distributions; load trained weights with
    ``load_state_dict`` (see ``convert.from_flax``)."""

    def __init__(self, config: ClipConfig = VIT_B32, dtype: torch.dtype = torch.float32,
                 qkv_attention: Optional[QkvAttention] = None,
                 attention_fn: Optional[AttentionFn] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.visual = VisionTransformer(cfg, dtype, qkv_attention, attention_fn) if cfg.is_vit \
            else ModifiedResNet(cfg, dtype)
        self.transformer = TransformerStack(cfg.transformer_width, cfg.transformer_layers,
                                            cfg.transformer_heads, dtype, qkv_attention,
                                            attention_fn)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.transformer_width))
        self.ln_final = LayerNormF32(cfg.transformer_width)
        self.text_projection = nn.Parameter(torch.empty(cfg.transformer_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.register_buffer(
            "causal_mask",
            torch.full((cfg.context_length,) * 2, float("-inf")).triu(1), persistent=False)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        """Random weights with the distributions of the Flax initialisers
        (eoe_tpu/models/clip/model.py:195-349), drawn on the CPU from ``g``;
        batch-norm averages at 0 and 1."""
        for name, p in self.named_parameters():
            cpu = torch.empty(p.shape)
            if name.endswith("patch_embed.kernel"):
                _lecun_normal_(cpu, math.prod(p.shape[:3]), g)
            elif name.endswith(".weight") and p.ndim == 4:   # nn.Conv kernels
                _lecun_normal_(cpu, math.prod(p.shape[1:]), g)
            elif name.endswith(".weight") and p.ndim == 2 and "token_embedding" not in name:
                _lecun_normal_(cpu, p.shape[1], g)          # nn.Dense kernels
            elif name == "visual.attnpool.positional_embedding":
                cpu.normal_(0.0, (self.config.vision_width * 32) ** -0.5, generator=g)
            elif name.startswith("visual.") and name.split(".")[1] in (
                    "class_embedding", "positional_embedding", "proj"):
                cpu.normal_(0.0, self.config.vision_width ** -0.5, generator=g)
            elif name == "token_embedding.weight":
                cpu.normal_(0.0, 0.02, generator=g)
            elif name == "positional_embedding":
                cpu.normal_(0.0, 0.01, generator=g)
            elif name == "text_projection":
                cpu.normal_(0.0, self.config.transformer_width ** -0.5, generator=g)
            elif name == "logit_scale":
                cpu.fill_(math.log(1 / 0.07))
            elif name.endswith(".weight"):                   # LayerNorm and BN scales
                cpu.fill_(1.0)
            else:                                            # biases
                cpu.zero_()
            p.copy_(cpu)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images.to(self.dtype))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding.weight[tokens].to(self.dtype)
        x = x + self.positional_embedding.to(x.dtype)
        x = self.transformer(x, self.causal_mask, causal=True)
        x = self.ln_final(x)
        # EOT pooling: the eot token has the highest id in each row
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)

    def contrastive(self, images: torch.Tensor, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        vi = self.encode_image(images)
        vt = self.encode_text(tokens)
        vi = vi / vi.norm(dim=-1, keepdim=True)
        vt = vt / vt.norm(dim=-1, keepdim=True)
        # the fp32 logit scale promotes the product to fp32, as in JAX
        logits_per_image = (self.logit_scale.exp() * vi.float()) @ vt.float().T
        return logits_per_image, logits_per_image.T

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encode_image(images)
