"""Weights carried between the JAX package's Flax CLIP and the port's.

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
"""

import re
from typing import Any, Dict

import numpy as np
import torch

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
