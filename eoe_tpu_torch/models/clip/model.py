"""CLIP (ViT variants) in PyTorch: the port of eoe_tpu/models/clip/model.py.

Same architecture and numerics as the Flax model: QuickGELU MLPs, pre-LN
residual blocks, LayerNorm computed in fp32, causal text encoder with EOT
pooling by argmax over token ids, class-token pooling and projection for the
ViT. Images are NHWC, as in the JAX package.

Parameters stay fp32; ``dtype`` is the compute dtype. Every dense layer casts
its input, weight and bias to ``dtype`` explicitly, as Flax ``nn.Dense(dtype=)``
does (no autocast). Attention runs through the fused-QKV CUDA kernel when it
applies (``fused_qkv_ok``) and the mask is none or causal, else through
``default_attention``; ``qkv_attention`` replaces the kernel by another
function of the same signature, e.g. its plain version
``fused_qkv_attention_ref``. ``ModifiedResNet`` is not ported yet.
"""

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from eoe_tpu_torch.ops.attention import default_attention, fused_qkv_attention, fused_qkv_ok

QkvAttention = Callable[[torch.Tensor, int, bool], torch.Tensor]


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
                 qkv_attention: Optional[QkvAttention] = None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.qkv_attention = qkv_attention
        self.qkv = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        n, s, d = x.shape
        hd = d // self.heads
        qkv = _dense(x, self.qkv, self.dtype)
        if mask is None or causal:
            if self.qkv_attention is not None:
                return _dense(self.qkv_attention(qkv, self.heads, causal), self.attn_out, self.dtype)
            if fused_qkv_ok(n, s, self.heads, hd, qkv):
                return _dense(fused_qkv_attention(qkv, self.heads, causal), self.attn_out, self.dtype)
        q, k, v = (t.reshape(n, s, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = default_attention(q, k, v, mask).transpose(1, 2).reshape(n, s, d)
        return _dense(attn, self.attn_out, self.dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 qkv_attention: Optional[QkvAttention] = None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNormF32(width)
        self.attn = MultiHeadAttention(width, heads, dtype, qkv_attention)
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
                 qkv_attention: Optional[QkvAttention] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, qkv_attention) for _ in range(layers))

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
                 qkv_attention: Optional[QkvAttention] = None):
        super().__init__()
        w = cfg.vision_width
        grid = cfg.image_resolution // cfg.vision_patch_size
        self.patch_embed = PatchEmbed(w, cfg.vision_patch_size, 3, dtype)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, w))
        self.ln_pre = LayerNormF32(w)
        self.transformer = TransformerStack(w, cfg.vision_layers, cfg.vision_heads, dtype,
                                            qkv_attention)
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


class CLIP(nn.Module):
    """Full CLIP with ``encode_image`` / ``encode_text`` / ``contrastive``;
    ``forward(images)`` returns image features only, as the JAX model does.

    Built with random weights from ``generator`` (default: seed 0) following
    the Flax initialisers' distributions; load trained weights with
    ``load_state_dict`` (see ``convert.from_flax``)."""

    def __init__(self, config: ClipConfig = VIT_B32, dtype: torch.dtype = torch.float32,
                 qkv_attention: Optional[QkvAttention] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not config.is_vit:
            raise NotImplementedError("the ModifiedResNet CLIP variants are not ported yet")
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.visual = VisionTransformer(cfg, dtype, qkv_attention)
        self.transformer = TransformerStack(cfg.transformer_width, cfg.transformer_layers,
                                            cfg.transformer_heads, dtype, qkv_attention)
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
        (eoe_tpu/models/clip/model.py:195-349), drawn on the CPU from ``g``."""
        for name, p in self.named_parameters():
            cpu = torch.empty(p.shape)
            if name.endswith("patch_embed.kernel"):
                _lecun_normal_(cpu, math.prod(p.shape[:3]), g)
            elif name.endswith(".weight") and p.ndim == 2 and "token_embedding" not in name:
                _lecun_normal_(cpu, p.shape[1], g)          # nn.Dense kernels
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
            elif name.endswith(".weight"):                   # LayerNorm scales
                cpu.fill_(1.0)
            else:                                            # biases
                cpu.zero_()
            p.copy_(cpu)

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
