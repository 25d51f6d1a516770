"""Weights carried into the port's CLIP: from the JAX package's Flax CLIP,
and from an OpenAI CLIP checkpoint.

``from_flax`` takes the Flax ``params`` tree of ``eoe_tpu.models.clip.CLIP``
as numpy arrays (as ``jax.device_get`` or ``flax.serialization
.msgpack_restore`` give it), and for the ResNet variants its
``batch_stats``, and returns the port's ``state_dict``; ``to_flax_numpy``
goes the other way for the params, ``to_flax_variables`` for both
collections. The mapping:

  * ``Dense`` kernels ``(in, out)`` -> ``Linear.weight`` ``(out, in)``
    (``qkv`` columns stay ordered [q | k | v], heads contiguous in each),
  * ``Conv`` kernels (HWIO) -> ``weight`` (OIHW), the ViT's
    ``patch_embed/kernel`` aside, which keeps its HWIO shape,
  * ``LayerNormF32``'s ``ln/scale``, ``ln/bias`` -> ``weight``, ``bias``;
    a batch norm's ``scale`` -> ``weight``, its ``batch_stats`` ``mean`` /
    ``var`` -> ``running_mean`` / ``running_var``,
  * ``blockN`` -> ``blocks.N``,
  * ``token_embedding/embedding`` -> ``token_embedding.weight``,
  * everything else (embeddings, projections, ``logit_scale``) maps as it
    is.

``load_checkpoint`` reads an OpenAI checkpoint file (a TorchScript archive
or a plain state dict), ``config_from_state_dict`` derives its architecture
from the tensor shapes, and ``from_openai`` converts its state dict: the
joint ``attn.in_proj_weight`` (3D, D), whose rows are [q | k | v] with the
heads contiguous in each, is the port's ``attn.qkv.weight`` as it is;
``out_proj`` -> ``attn_out``, ``mlp.c_fc`` / ``mlp.c_proj`` -> ``mlp_up`` /
``mlp_down``, ``resblocks.N`` -> ``blocks.N``, ``conv1.weight`` (OIHW) ->
``patch_embed.kernel`` (HWIO) for the ViT; for the ResNets
``layerS.B`` -> ``layerS_B``, ``downsample.0`` / ``downsample.1`` ->
``down_conv`` / ``down_bn``, the convolutions (OIHW), batch norms with
their running averages and ``attnpool`` as they are, and torch's
``num_batches_tracked`` counters dropped; fp16 becomes fp32.
``to_openai`` writes the port's weights in that format.
"""

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from eoe_tpu_torch.models.clip.model import ClipConfig
from eoe_tpu_torch.models.resnet50 import BN_KEYS, bottleneck_keys

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch(path, value: np.ndarray):
    """A Flax params leaf -> (port key, value in the port's layout)."""
    path = list(path)
    if path[-2:] in (["ln", "scale"], ["ln", "bias"]):
        path[-2:] = ["weight" if path[-1] == "scale" else "bias"]
    elif path == ["token_embedding", "embedding"] or path[-1] == "scale":
        path[-1] = "weight"
    elif path[-1] == "kernel" and path[-2] != "patch_embed":
        path[-1] = "weight"
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    return ".".join(re.sub(r"^block(\d+)$", r"blocks.\1", p) for p in path), value


def _to_flax(key: str, value: np.ndarray):
    """A port state-dict entry -> (collection, Flax path, value)."""
    path = re.sub(r"\bblocks\.(\d+)\b", r"block\1", key).split(".")
    if path[-1] in _STATS_BACK:
        return "batch_stats", path[:-1] + [_STATS_BACK[path[-1]]], value
    if len(path) >= 2 and path[-2].startswith("ln_"):
        path[-1:] = ["ln", "scale" if path[-1] == "weight" else "bias"]
    elif path == ["token_embedding", "weight"]:
        path[-1] = "embedding"
    elif path[-1] == "weight" and value.ndim == 1:
        path[-1] = "scale"
    elif path[-1] == "weight":
        path[-1] = "kernel"
        value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
    return "params", path, value


def from_flax(params: Dict[str, Any],
              batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Flax CLIP params (and batch statistics; numpy leaves) -> the port's
    CLIP ``state_dict``."""
    sd = {}
    for path, value in _flatten(params):
        key, value = _to_torch(path, np.asarray(value, dtype=np.float32))
        sd[key] = torch.from_numpy(np.array(value, order="C"))
    for path, value in _flatten(batch_stats or {}):
        key = ".".join(path[:-1] + (_STATS[path[-1]],))
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return sd


def to_flax_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's CLIP ``state_dict`` -> Flax ``{"params", "batch_stats"}``
    trees of numpy arrays (``batch_stats`` only for a ResNet tower)."""
    trees: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        collection, path, value = _to_flax(key, value.detach().cpu().float().numpy())
        node = trees[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, order="C")
    return {k: v for k, v in trees.items() if v or k == "params"}


def to_flax_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's CLIP ``state_dict`` -> a Flax params tree of numpy arrays."""
    return to_flax_variables(state_dict)["params"]


OPENAI_META = ("input_resolution", "context_length", "vocab_size")
_BLOCK_KEYS = (("ln_1.weight", "ln_1.weight"), ("ln_1.bias", "ln_1.bias"),
               ("ln_2.weight", "ln_2.weight"), ("ln_2.bias", "ln_2.bias"),
               ("attn.in_proj_weight", "attn.qkv.weight"),
               ("attn.in_proj_bias", "attn.qkv.bias"),
               ("attn.out_proj.weight", "attn.attn_out.weight"),
               ("attn.out_proj.bias", "attn.attn_out.bias"),
               ("mlp.c_fc.weight", "mlp_up.weight"), ("mlp.c_fc.bias", "mlp_up.bias"),
               ("mlp.c_proj.weight", "mlp_down.weight"), ("mlp.c_proj.bias", "mlp_down.bias"))
_PATCH = ("visual.conv1.weight", "visual.patch_embed.kernel")


def config_from_state_dict(sd: Dict[str, Any]) -> ClipConfig:
    """The architecture of an OpenAI CLIP state dict, from its shapes: a ViT
    has ``visual.proj``; a ResNet's per-stage block counts, width and
    resolution (32 x the attention pool's grid) come from its layers."""
    if "visual.proj" in sd:
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        vision = dict(image_resolution=patch * grid,
                      vision_layers=len([k for k in sd if k.startswith("visual.")
                                         and k.endswith(".attn.in_proj_weight")]),
                      vision_width=sd["visual.conv1.weight"].shape[0], vision_patch_size=patch)
    else:
        vision = dict(vision_layers=tuple(len({k.split(".")[2] for k in sd
                                               if k.startswith(f"visual.layer{b}")})
                                          for b in (1, 2, 3, 4)),
                      vision_width=sd["visual.layer1.0.conv1.weight"].shape[0],
                      vision_patch_size=None)
        grid = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision["image_resolution"] = 32 * grid
    width = sd["ln_final.weight"].shape[0]
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_heads=max(1, width // 64),
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        **vision)


def _openai_keys(cfg: ClipConfig) -> Dict[str, str]:
    """OpenAI key -> port key, the ViT's patch embedding aside."""
    keys = {k: k for k in ("token_embedding.weight", "positional_embedding",
                           "text_projection", "logit_scale")}
    keys.update({f"ln_final.{a}": f"ln_final.{a}" for a in ("weight", "bias")})
    towers = [("transformer", "transformer", cfg.transformer_layers)]
    if cfg.is_vit:
        keys.update({k: k for k in ("visual.class_embedding", "visual.positional_embedding",
                                    "visual.proj")})
        for ln in ("visual.ln_pre", "visual.ln_post"):
            keys.update({f"{ln}.weight": f"{ln}.weight", f"{ln}.bias": f"{ln}.bias"})
        towers.append(("visual.transformer", "visual.transformer", cfg.vision_layers))
    else:
        for i in (1, 2, 3):
            keys[f"visual.conv{i}.weight"] = f"visual.conv{i}.weight"
            keys.update({f"visual.bn{i}.{a}": f"visual.bn{i}.{a}" for a in BN_KEYS})
        keys.update(bottleneck_keys(cfg.vision_layers, "visual.", "visual."))
        keys["visual.attnpool.positional_embedding"] = "visual.attnpool.positional_embedding"
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            keys.update({f"visual.attnpool.{proj}.{a}": f"visual.attnpool.{proj}.{a}"
                         for a in ("weight", "bias")})
    for src, dst, layers in towers:
        for i in range(layers):
            keys.update({f"{src}.resblocks.{i}.{a}": f"{dst}.blocks.{i}.{b}"
                         for a, b in _BLOCK_KEYS})
    return keys


def from_openai(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict -> the port's CLIP ``state_dict`` (fp32)."""
    sd = {k: v for k, v in sd.items()
          if k not in OPENAI_META and not k.endswith(".num_batches_tracked")}
    cfg = config_from_state_dict(sd)
    keys = _openai_keys(cfg)
    patch = {_PATCH[0]} if cfg.is_vit else set()
    unknown = sorted(set(sd) - set(keys) - patch)
    if unknown:
        raise KeyError(f"unexpected keys in the CLIP state dict: {unknown[:5]}")
    out = {port: torch.as_tensor(sd[k]).detach().float().contiguous()
           for k, port in keys.items()}
    if cfg.is_vit:
        out[_PATCH[1]] = torch.as_tensor(sd[_PATCH[0]]).detach().float().permute(
            2, 3, 1, 0).contiguous()
    return out


def to_openai(state_dict: Dict[str, torch.Tensor], config: ClipConfig,
              dtype: torch.dtype = torch.float16) -> Dict[str, torch.Tensor]:
    """The port's CLIP ``state_dict`` -> an OpenAI-format state dict in
    ``dtype``, as the published checkpoints store it (a ResNet's batch norms
    with torch's ``num_batches_tracked`` counters, at 0)."""
    out = {k: state_dict[port].detach().to(dtype).contiguous()
           for k, port in _openai_keys(config).items()}
    if config.is_vit:
        out[_PATCH[0]] = state_dict[_PATCH[1]].detach().permute(3, 2, 0, 1).to(
            dtype).contiguous()
    else:
        for k in [k for k in out if k.endswith(".running_mean")]:
            out[k.replace(".running_mean", ".num_batches_tracked")] = torch.zeros(
                (), dtype=torch.long)
    return out


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The raw state dict of an OpenAI CLIP checkpoint file: a TorchScript
    archive, as published, or else a plain ``torch.save`` of a state dict."""
    with open(path, "rb") as f:
        try:
            return torch.jit.load(f, map_location="cpu").state_dict()
        except RuntimeError:
            f.seek(0)
            return torch.load(f, map_location="cpu", weights_only=True)
