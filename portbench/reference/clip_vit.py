"""Plain PyTorch CLIP ViT (Radford et al. 2021, github.com/openai/CLIP
``clip/model.py``): the image and text towers, the prompt centre, the
prompt-contrastive loss and the anomaly score of the EOE objective.

The parameters are a flat dict of float32 tensors under the names and
layouts the benchmark hands to both sides (``param_specs``): dense weights
``(out, in)``, the joint ``qkv`` projection as the q, k and v rows one after
another (heads contiguous within each), the patch embedding as a
``(patch, patch, channels, width)`` kernel over patches flattened in that
order, images NHWC. Pre-LN residual blocks, QuickGELU, LayerNorm eps 1e-5,
the class token first, the text tower causal with EOT pooling (the largest
token id of a row). Attention is softmax(q k^T / sqrt(d)) v, written out.
Every product goes through a ``precision.Precision``.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]


def param_specs(cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, how it is drawn): ("normal", std), ("ones", std) for
    a scale of 1 plus noise of ``std``, ("const", value)."""
    w, tw = cfg["vision_width"], cfg["transformer_width"]
    p, e = cfg["vision_patch_size"], cfg["embed_dim"]
    grid = cfg["image_resolution"] // p
    out = {}

    def blocks(prefix: str, width: int, layers: int):
        for i in range(layers):
            b = f"{prefix}blocks.{i}."
            for ln in ("ln_1", "ln_2"):
                out[b + ln + ".weight"] = ((width,), ("ones", 0.02))
                out[b + ln + ".bias"] = ((width,), ("normal", 0.02))
            for name, fan_out, fan_in in (("attn.qkv", 3 * width, width),
                                          ("attn.attn_out", width, width),
                                          ("mlp_up", 4 * width, width),
                                          ("mlp_down", width, 4 * width)):
                out[b + name + ".weight"] = ((fan_out, fan_in), ("normal", fan_in ** -0.5))
                out[b + name + ".bias"] = ((fan_out,), ("normal", 0.02))

    out["positional_embedding"] = ((cfg["context_length"], tw), ("normal", 0.01))
    out["text_projection"] = ((tw, e), ("normal", tw ** -0.5))
    out["logit_scale"] = ((), ("const", math.log(1 / 0.07)))
    out["visual.class_embedding"] = ((w,), ("normal", w ** -0.5))
    out["visual.positional_embedding"] = ((grid * grid + 1, w), ("normal", w ** -0.5))
    out["visual.proj"] = ((w, e), ("normal", w ** -0.5))
    out["visual.patch_embed.kernel"] = ((p, p, 3, w), ("normal", (p * p * 3) ** -0.5))
    for ln in ("ln_pre", "ln_post"):
        out[f"visual.{ln}.weight"] = ((w,), ("ones", 0.02))
        out[f"visual.{ln}.bias"] = ((w,), ("normal", 0.02))
    blocks("visual.transformer.", w, cfg["vision_layers"])
    blocks("transformer.", tw, cfg["transformer_layers"])
    out["token_embedding.weight"] = ((cfg["vocab_size"], tw), ("normal", 0.02))
    out["ln_final.weight"] = ((tw,), ("ones", 0.02))
    out["ln_final.bias"] = ((tw,), ("normal", 0.02))
    return out


def trainable(name: str) -> bool:
    """The fine-tune trains the image tower alone."""
    return name.startswith("visual.")


def layer_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], 1e-5)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """(n, h, s, d) each; float32."""
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def block(x, p: Params, b: str, heads: int, causal: bool, P: Precision) -> torch.Tensor:
    n, s, w = x.shape
    hd = w // heads
    qkv = P.linear(layer_norm(x, p, b + "ln_1"), p[b + "attn.qkv.weight"], p[b + "attn.qkv.bias"])
    q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2) for t in qkv.split(w, dim=-1))
    a = attention(q, k, v, causal).transpose(1, 2).reshape(n, s, w)
    x = x + P.linear(a, p[b + "attn.attn_out.weight"], p[b + "attn.attn_out.bias"])
    h = P.linear(layer_norm(x, p, b + "ln_2"), p[b + "mlp_up.weight"], p[b + "mlp_up.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + P.linear(h, p[b + "mlp_down.weight"], p[b + "mlp_down.bias"])


def encode_image(p: Params, images: torch.Tensor, cfg: dict, P: Precision) -> torch.Tensor:
    """(n, res, res, 3) float images, CLIP-normalised -> (n, embed_dim)."""
    ps, w = cfg["vision_patch_size"], cfg["vision_width"]
    n, h, wd, c = images.shape
    g = h // ps
    patches = images.float().reshape(n, g, ps, wd // ps, ps, c).permute(0, 1, 3, 2, 4, 5)
    x = P.mm(patches.reshape(n, g * (wd // ps), ps * ps * c),
             p["visual.patch_embed.kernel"].reshape(ps * ps * c, w))
    cls = p["visual.class_embedding"].reshape(1, 1, w).expand(n, 1, w)
    x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
    x = layer_norm(x, p, "visual.ln_pre")
    heads = w // 64
    for i in range(cfg["vision_layers"]):
        x = block(x, p, f"visual.transformer.blocks.{i}.", heads, False, P)
    return P.mm(layer_norm(x[:, 0], p, "visual.ln_post"), p["visual.proj"])


def encode_text(p: Params, tokens: torch.Tensor, cfg: dict, P: Precision) -> torch.Tensor:
    """(k, context) token ids -> (k, embed_dim)."""
    x = p["token_embedding.weight"][tokens] + p["positional_embedding"]
    for i in range(cfg["transformer_layers"]):
        x = block(x, p, f"transformer.blocks.{i}.", cfg["transformer_heads"], True, P)
    x = layer_norm(x, p, "ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return P.mm(x, p["text_projection"])


def prompt_centre(p: Params, tokens: torch.Tensor, cfg: dict, P: Precision) -> torch.Tensor:
    """The prompts' L2-normalised text features, anomaly prompt last."""
    with torch.no_grad():
        f = encode_text(p, tokens, cfg, P)
    return f / f.norm(dim=-1, keepdim=True)


def masked_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum() / w.sum().clamp(min=1.0)


def loss_terms(feats: torch.Tensor, labels: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """Per-sample one-vs-rest prompt losses: normal samples (label 0) take
    -log p(prompt 0), anomalous ones -log p(anomaly prompt) under the softmax
    of 100 x cosine similarity."""
    v = feats / feats.norm(dim=-1, keepdim=True)
    logp = torch.log_softmax(100.0 * v @ centre.t(), dim=-1)
    return -torch.where(labels == 1, logp[:, -1], logp[:, 0])


def score(feats: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """The probability of the anomaly prompt."""
    t = centre / centre.norm(dim=-1, keepdim=True)
    v = feats / feats.norm(dim=-1, keepdim=True)
    return torch.softmax(100.0 * v @ t.t(), dim=-1)[:, -1]
