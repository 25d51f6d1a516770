"""Reference (torch) snapshots into port snapshots: the port of
eoe_tpu/models/torch_import.py.

The reference saves ``{'net': state_dict, 'opt', 'sched', 'epoch',
'ds_statistics'}`` with ``torch.save`` and also takes bare tensor dicts as
CustomNet feature models. ``import_torch_snapshot`` turns such a file into
the snapshot payload the port's ``--load`` reads (``Trainer.load``):
``{params, opt_state, epoch, ds_statistics, setup}``, with
``setup={"imported_from": <path>}``. The optimizer and scheduler states
are not carried: the importing trainer starts a fresh optimizer, as the
reference does with ``opt=None`` (an empty ``opt_state``).

The port keeps torch's layouts, so a weight is copied under the port's name
(no OIHW -> HWIO and no (out, in) -> (in, out) transposes, unlike the JAX
package). One permutation stays: the CNNs' first fc after the NCHW flatten
takes its input in c-major order in the reference and in (h, w, c) order
in the port (``models/cnn.py``), so its columns are reordered; the weight
keeps torch's (out, in) layout. Batch norms keep their running averages;
torch's ``num_batches_tracked`` counters are dropped.

The architecture is sniffed from the keys: OpenAI-style CLIP
(``models.clip.convert.from_openai``), torchvision (wide_)resnet50 trunks
(``models.resnet50``; the fc head is not converted), WideResNet+CBAM and
CNN28 / CNN32. Files are read on the CPU; nothing here touches a card.
"""

from typing import Dict

import numpy as np
import torch

_BN = ("running_mean", "running_var")


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().cpu().float().contiguous()


def _copy(sd: Dict, out: Dict, src: str, dst: str, leaves=("weight", "bias")):
    """``src.leaf`` -> ``dst.leaf`` for every leaf present."""
    for leaf in leaves:
        if f"{src}.{leaf}" in sd:
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])


def _bn(sd: Dict, out: Dict, src: str, dst: str):
    _copy(sd, out, src, dst, ("weight", "bias") + _BN)


def _flat_lin(w, c: int, h: int, ww: int) -> torch.Tensor:
    """The fc after an NCHW flatten: input columns c*h*w -> h*w*c."""
    w = _t(w)
    out = w.shape[0]
    return w.reshape(out, c, h, ww).permute(0, 2, 3, 1).reshape(out, -1).contiguous()


# ----------------------------------------------------------------- CNNs


def cnn_state_from_torch(sd: Dict) -> Dict[str, torch.Tensor]:
    """CNN28 or CNN32 (reference cnn.py) -> the port's ``state_dict``."""
    is32 = "conv3.weight" in sd
    out: Dict[str, torch.Tensor] = {}
    for i in ((1, 2, 3) if is32 else (1, 2)):
        _copy(sd, out, f"conv{i}", f"conv{i}")
        _bn(sd, out, f"bn2d{i}", f"bn2d{i}")
    out["fc1.weight"] = _flat_lin(sd["fc1.weight"], *((128, 4, 4) if is32 else (32, 7, 7)))
    _copy(sd, out, "fc1", "fc1", ("bias",))
    _bn(sd, out, "bn1d1", "bn1d1")
    _copy(sd, out, "fc2", "fc2")
    _copy(sd, out, "linear", "linear")
    return out


# ------------------------------------------------------------ WideResNet


def cbam_state_from_torch(sd: Dict, src: str, dst: str, out: Dict):
    """A reference CBAM at prefix ``src`` -> the port's at ``dst``."""
    _copy(sd, out, f"{src}.ChannelGate.mlp.1", f"{dst}.channel_gate.mlp_hidden")
    _copy(sd, out, f"{src}.ChannelGate.mlp.3", f"{dst}.channel_gate.mlp_out")
    _copy(sd, out, f"{src}.SpatialGate.spatial.conv", f"{dst}.spatial_gate.spatial_conv")
    _bn(sd, out, f"{src}.SpatialGate.spatial.bn", f"{dst}.spatial_gate.spatial_bn")


def wideresnet_state_from_torch(sd: Dict) -> Dict[str, torch.Tensor]:
    """hendrycks/ss-ood WideResNet+CBAM (reference resnet.py:25-154) -> the
    port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    _copy(sd, out, "conv1", "conv1")
    _bn(sd, out, "bn1", "bn1")
    stage = 1
    while f"layer{stage}.0.conv1.weight" in sd:
        block = 0
        while f"layer{stage}.{block}.conv1.weight" in sd:
            src, dst = f"layer{stage}.{block}", f"layer{stage}_block{block}"
            for i in (1, 2):
                _copy(sd, out, f"{src}.conv{i}", f"{dst}.conv{i}")
                _bn(sd, out, f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample.0.weight" in sd:
                _copy(sd, out, f"{src}.downsample.0", f"{dst}.down_conv")
                _bn(sd, out, f"{src}.downsample.1", f"{dst}.down_bn")
            if f"{src}.cbam.ChannelGate.mlp.1.weight" in sd:
                cbam_state_from_torch(sd, f"{src}.cbam", f"{dst}.cbam", out)
            block += 1
        stage += 1
    _copy(sd, out, "fc", "fc")
    _copy(sd, out, "linear", "linear")
    return out


# ----------------------------------------------------------------- dispatch


def _bottleneck_layout(sd: Dict) -> tuple:
    """Blocks per stage of a torchvision ResNet state dict."""
    layout, stage = [], 1
    while f"layer{stage}.0.conv1.weight" in sd:
        block = 0
        while f"layer{stage}.{block}.conv1.weight" in sd:
            block += 1
        layout.append(block)
        stage += 1
    return tuple(layout)


def state_from_torch(sd: Dict) -> Dict[str, torch.Tensor]:
    """Sniff the architecture from the state-dict keys and convert."""
    if "visual.conv1.weight" in sd or "token_embedding.weight" in sd:
        from eoe_tpu_torch.models.clip.convert import from_openai
        return from_openai(sd)
    if "layer1.0.conv3.weight" in sd:
        # bottleneck blocks: the torchvision (wide_)resnet50 family, the
        # reference's WideResNet50Pretrained backbone; its fc is not carried
        from eoe_tpu_torch.models.resnet50 import load_torchvision_state_dict
        return load_torchvision_state_dict(sd, layers=_bottleneck_layout(sd))
    if "layer1.0.conv1.weight" in sd:
        return wideresnet_state_from_torch(sd)
    if "conv1.weight" in sd and "fc1.weight" in sd:
        return cnn_state_from_torch(sd)
    raise ValueError(
        f"Cannot sniff a known architecture from state-dict keys "
        f"(got {sorted(sd)[:8]}...). Supported: CNN28/CNN32, WideResNet+CBAM, "
        f"torchvision (wide_)resnet50, OpenAI-style CLIP.")


def _as_list(v) -> list:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v).tolist()


def import_torch_snapshot(in_path: str, out_path: str) -> str:
    """Convert a reference torch snapshot file into a port snapshot at
    ``out_path`` (``torch.save``). Returns ``out_path``."""
    snapshot = torch.load(in_path, map_location="cpu", weights_only=False)
    if not (isinstance(snapshot, dict) and isinstance(snapshot.get("net"), dict)):
        # a bare tensor dict is a CustomNet feature model
        if isinstance(snapshot, dict) and all(
                hasattr(t, "detach") for t in snapshot.values()):
            if "layer1.0.conv3.weight" in snapshot:
                # the one torchvision backbone with an architecture here
                # (wide_resnet50_2, models/resnet50.py): a trunk-only
                # snapshot, to which the trainer adds a fresh head
                snapshot = {"net": snapshot}
            else:
                raise ValueError(
                    "This is a bare feature-model state dict (CustomNet style); "
                    "those depend on the torchvision architecture and are not "
                    "auto-convertible (only (wide_)resnet50-family backbones "
                    "are). Convert the full EOE-style snapshot instead.")
        else:
            raise ValueError("Cannot parse snapshot (no 'net' entry).")
    payload = {
        "params": state_from_torch(snapshot["net"]),
        "opt_state": {},   # a fresh optimizer on load
        "epoch": int(snapshot.get("epoch") or 0),
        "ds_statistics": {k: _as_list(v)
                          for k, v in (snapshot.get("ds_statistics") or {}).items()},
        "setup": {"imported_from": in_path},
    }
    torch.save(payload, out_path)
    return out_path
