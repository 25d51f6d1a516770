"""Weights carried into the port's CLIP: from the JAX package's Flax CLIP,
and from an OpenAI CLIP checkpoint.

``from_flax`` takes the Flax ``params`` tree of ``eoe_tpu.models.clip.CLIP``
as numpy arrays (as ``jax.device_get`` or ``flax.serialization
.msgpack_restore`` give it) and returns the port's ``state_dict``;
``to_flax_numpy`` goes the other way. The mapping:

  * ``Dense`` kernels ``(in, out)`` -> ``Linear.weight`` ``(out, in)``
    (``qkv`` columns stay ordered [q | k | v], heads contiguous in each),
  * ``LayerNormF32``'s ``ln/scale``, ``ln/bias`` -> ``weight``, ``bias``,
  * ``blockN`` -> ``blocks.N``,
  * ``token_embedding/embedding`` -> ``token_embedding.weight``,
  * everything else (the HWIO ``patch_embed/kernel``, embeddings,
    projections, ``logit_scale``) maps as it is.

``load_checkpoint`` reads an OpenAI checkpoint file (a TorchScript archive
or a plain state dict), ``config_from_state_dict`` derives its architecture
from the tensor shapes, and ``from_openai`` converts its state dict: the
joint ``attn.in_proj_weight`` (3D, D), whose rows are [q | k | v] with the
heads contiguous in each, is the port's ``attn.qkv.weight`` as it is;
``out_proj`` -> ``attn_out``, ``mlp.c_fc`` / ``mlp.c_proj`` -> ``mlp_up`` /
``mlp_down``, ``resblocks.N`` -> ``blocks.N``, ``conv1.weight`` (OIHW) ->
``patch_embed.kernel`` (HWIO); fp16 becomes fp32. ``to_openai`` writes the
port's weights in that format. Only the ViT variants convert: the
ModifiedResNet image tower is not ported yet.
"""

import re
from typing import Any, Dict

import numpy as np
import torch

from eoe_tpu_torch.models.clip.model import ClipConfig

DENSE = ("qkv", "attn_out", "mlp_up", "mlp_down")


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_key(path) -> str:
    path = list(path)
    if path[-2:] == ["ln", "scale"]:
        path[-2:] = ["weight"]
    elif path[-2:] == ["ln", "bias"]:
        path[-2:] = ["bias"]
    elif len(path) >= 2 and path[-2] in DENSE and path[-1] == "kernel":
        path[-1] = "weight"
    elif path == ["token_embedding", "embedding"]:
        path[-1] = "weight"
    return ".".join(re.sub(r"^block(\d+)$", r"blocks.\1", p) for p in path)


def _to_flax_path(key: str):
    path = re.sub(r"\bblocks\.(\d+)\b", r"block\1", key).split(".")
    if len(path) >= 2 and path[-2].startswith("ln_"):
        path[-1:] = ["ln", "scale" if path[-1] == "weight" else "bias"]
    elif len(path) >= 2 and path[-2] in DENSE and path[-1] == "weight":
        path[-1] = "kernel"
    elif path == ["token_embedding", "weight"]:
        path[-1] = "embedding"
    return path


def from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax CLIP params (numpy leaves) -> the port's CLIP ``state_dict``."""
    sd = {}
    for path, value in _flatten(params):
        value = np.asarray(value, dtype=np.float32)
        if len(path) >= 2 and path[-2] in DENSE and path[-1] == "kernel":
            value = value.T
        sd[_to_torch_key(path)] = torch.from_numpy(np.array(value, order="C"))
    return sd


def to_flax_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's CLIP ``state_dict`` -> a Flax params tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        path = _to_flax_path(key)
        value = value.detach().cpu().float().numpy()
        if len(path) >= 2 and path[-2] in DENSE and path[-1] == "kernel":
            value = value.T
        value = np.array(value, order="C")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


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
    """The architecture of an OpenAI CLIP state dict, from its shapes."""
    if "visual.proj" not in sd:
        raise NotImplementedError("ModifiedResNet is not ported yet")
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    width = sd["ln_final.weight"].shape[0]
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=patch * grid,
        vision_layers=len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_heads=max(1, width // 64),
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}))


def _openai_keys(cfg: ClipConfig) -> Dict[str, str]:
    """OpenAI key -> port key, the patch embedding aside."""
    keys = {k: k for k in ("visual.class_embedding", "visual.positional_embedding",
                           "visual.proj", "token_embedding.weight", "positional_embedding",
                           "text_projection", "logit_scale")}
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        keys.update({f"{ln}.weight": f"{ln}.weight", f"{ln}.bias": f"{ln}.bias"})
    for tower, layers in (("visual.transformer", cfg.vision_layers),
                          ("transformer", cfg.transformer_layers)):
        for i in range(layers):
            keys.update({f"{tower}.resblocks.{i}.{a}": f"{tower}.blocks.{i}.{b}"
                         for a, b in _BLOCK_KEYS})
    return keys


def from_openai(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict -> the port's CLIP ``state_dict`` (fp32)."""
    sd = {k: v for k, v in sd.items() if k not in OPENAI_META}
    keys = _openai_keys(config_from_state_dict(sd))
    unknown = sorted(set(sd) - set(keys) - {_PATCH[0]})
    if unknown:
        raise KeyError(f"unexpected keys in the CLIP state dict: {unknown[:5]}")
    out = {port: torch.as_tensor(sd[k]).detach().float().contiguous()
           for k, port in keys.items()}
    out[_PATCH[1]] = torch.as_tensor(sd[_PATCH[0]]).detach().float().permute(
        2, 3, 1, 0).contiguous()
    return out


def to_openai(state_dict: Dict[str, torch.Tensor], config: ClipConfig,
              dtype: torch.dtype = torch.float16) -> Dict[str, torch.Tensor]:
    """The port's CLIP ``state_dict`` -> an OpenAI-format state dict in
    ``dtype``, as the published checkpoints store it."""
    out = {k: state_dict[port].detach().to(dtype).contiguous()
           for k, port in _openai_keys(config).items()}
    out[_PATCH[0]] = state_dict[_PATCH[1]].detach().permute(3, 2, 0, 1).to(dtype).contiguous()
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
