"""Weights carried between the JAX package's Flax conv models (CNN28, CNN32,
AE32, CBAM, WideResNet, and a CustomNet: its ``feature_model`` subtree and
``final_linear``) and the port's.

``from_flax`` takes Flax ``variables`` (``{"params": ..., "batch_stats":
...}``, numpy leaves, as ``jax.device_get`` or ``flax.serialization
.msgpack_restore`` give them) and returns the port's ``state_dict``;
``to_flax_numpy`` goes the other way. The port's modules carry the Flax
names, so a key is the Flax path joined by dots, with the leaf renamed:

  * ``kernel`` -> ``weight``: conv HWIO -> ``(out, in, kh, kw)``, dense
    ``(in, out)`` -> ``(out, in)``, each a transpose, no permutation of rows
    (CNN32 flattens in (h, w, c) order, as the Flax model does);
  * ``scale`` -> ``weight`` and ``bias`` -> ``bias`` of a BN;
  * ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.
"""

from typing import Any, Dict

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _kernel_to_torch(value: np.ndarray) -> np.ndarray:
    return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T


def _kernel_to_flax(value: np.ndarray) -> np.ndarray:
    return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax conv-model variables (numpy leaves) -> the port's ``state_dict``."""
    sd = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            value = np.asarray(value, dtype=np.float32)
            *mods, leaf = path
            if collection == "batch_stats":
                leaf = _STATS[leaf]
            elif leaf == "kernel":
                leaf, value = "weight", _kernel_to_torch(value)
            elif leaf == "scale":
                leaf = "weight"
            sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(value, order="C"))
    return sd


def to_flax_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's conv-model ``state_dict`` -> Flax ``{"params", "batch_stats"}``
    trees of numpy arrays."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        value = value.detach().cpu().float().numpy()
        if leaf in _STATS_BACK:
            collection, leaf = "batch_stats", _STATS_BACK[leaf]
        elif leaf == "weight" and value.ndim == 1:
            collection, leaf = "params", "scale"
        elif leaf == "weight":
            collection, leaf, value = "params", "kernel", _kernel_to_flax(value)
        else:
            collection = "params"
        node = tree[collection]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(value, order="C")
    return {k: v for k, v in tree.items() if v}
