"""Evaluation preprocessing: the deterministic part of
eoe_tpu/ops/preprocess.py.

A pipeline is the same declarative list of specs (plain dicts / strings) the
JAX package records in setup.json and snapshots; ``compile_pipeline(specs,
stats)`` turns it into one batched function ``fn(images) -> images`` over
NHWC tensors, on whatever device the images lie on. uint8 inputs follow the
JAX order: an identity resize passes the bytes through, a real resize
converts to float (/255) first, every op that is not uint8-safe converts
first, and the result is converted once more at the end.

Resizes use ``F.interpolate`` with ``antialias=True``: that matches
``jax.image.resize`` ("cubic" -> bicubic, "linear" -> bilinear) to ~1e-6
for both up- and downscaling, where ``antialias=False`` misses by 0.1-0.2
(tests/test_torch_preprocess.py).

The random specs (crops, flips, jitter, noise) and the filters come with the
training slice; they raise ``PipelineError`` until then.
"""

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Spec = Union[str, Dict[str, Any]]

# CLIP's canonical normalization constants (public, from OpenAI CLIP preprocessing)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

NORM_PLACEHOLDERS = ("norm", "normalise", "normalize")
NOT_PORTED = ("random_crop", "random_hflip", "random_horizontal_flip", "color_jitter",
              "gaussian_noise", "grayscale", "blur", "sharpen", "hpf", "lpf", "minmax_norm",
              "gcn", "gcn-norm", "gcn-normalize", "gcn-normalise")
_MODES = {"linear": "bilinear", "bilinear": "bilinear", "cubic": "bicubic", "bicubic": "bicubic"}


@dataclasses.dataclass
class DatasetStats:
    """Per-channel statistics of the raw normal train split, as carried in
    snapshots."""
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    mode: int = 0  # 0 = STD_NORM, 1 = GCN_NORM

    def to_json(self):
        return {"mean": list(map(float, self.mean)), "std": list(map(float, self.std)),
                "mode": self.mode}

    @staticmethod
    def from_json(d):
        if d is None:
            return None
        return DatasetStats(tuple(d["mean"]), tuple(d["std"]), int(d.get("mode", 0)))


class PipelineError(ValueError):
    pass


def _to_float(images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def resize(images: torch.Tensor, size: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    n, h, w, c = images.shape
    if (h, w) == tuple(size):
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(size), mode=_MODES[method],
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _resize_u8(images: torch.Tensor, size: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    """An identity resize passes uint8 through; a real one converts first
    (interpolating in uint8 would quantize)."""
    if tuple(images.shape[1:3]) == tuple(size):
        return images
    return resize(_to_float(images), size, method)


def center_crop(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    n, h, w, c = images.shape
    th, tw = size
    # torchvision pads when the crop is larger than the image
    if th > h or tw > w:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        images = F.pad(images, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        n, h, w, c = images.shape
    i = (h - th) // 2
    j = (w - tw) // 2
    return images[:, i:i + th, j:j + tw, :]


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _normalize_rt(images: torch.Tensor, rt_stats, mean, std) -> torch.Tensor:
    """Normalize preferring runtime stats (one pipeline serves every class)."""
    if rt_stats is not None:
        return normalize(images, rt_stats[0], rt_stats[1])
    return normalize(images, mean, std)


def _clip_pil(images: torch.Tensor, res: int) -> torch.Tensor:
    # bicubic resize + RGB expansion of grayscale rasters to CLIP's input
    if images.shape[-1] == 1:
        images = images.repeat(1, 1, 1, 3)  # index-only: uint8-safe
    return _resize_u8(images, size=(res, res), method="cubic")


def _size(s: Dict[str, Any]) -> Tuple[int, int]:
    size = s["size"]
    return (size, size) if isinstance(size, int) else tuple(size)


def compile_pipeline(specs: Sequence[Spec], stats: Optional[DatasetStats] = None
                     ) -> Callable[..., torch.Tensor]:
    """Compile deterministic transform specs into one batched function
    ``fn(images, rt_stats=None) -> images`` (NHWC in, NHWC float out)."""
    steps: List[Tuple[Callable, bool, bool]] = []  # (fn, uint8-safe, takes rt_stats)
    for raw in specs or ():
        s = {"op": raw} if isinstance(raw, str) else dict(raw)
        op = s["op"].lower()
        if op in ("to_tensor", "totensor", "rgb"):
            continue  # images are already NHWC
        elif op == "resize":
            steps.append((partial(_resize_u8, size=_size(s), method=s.get("method", "linear")),
                          True, False))
        elif op == "center_crop":
            steps.append((partial(center_crop, size=_size(s)), True, False))
        elif op == "clip_pil_preprocessing":
            steps.append((partial(_clip_pil, res=int(s.get("resolution", 224))), True, False))
        elif op == "clip_tensor_preprocessing":
            steps.append((partial(normalize, mean=CLIP_MEAN, std=CLIP_STD), False, False))
        elif op == "normalize_with":
            steps.append((partial(normalize, mean=tuple(s["mean"]), std=tuple(s["std"])),
                          False, False))
        elif op in NORM_PLACEHOLDERS:
            if stats is None:
                raise PipelineError(
                    "pipeline contains 'normalize' but no dataset statistics were provided; "
                    "they are extracted from the raw normal train split")
            steps.append((partial(_normalize_rt, mean=stats.mean, std=stats.std), False, True))
        elif op in NOT_PORTED:
            raise PipelineError(f"transform op {op!r} is not ported yet")
        elif op == "lambda":
            raise PipelineError("arbitrary lambdas are not serializable; add a named op instead")
        else:
            raise PipelineError(f"unknown transform op: {op!r} (spec {raw!r})")

    def apply(images: torch.Tensor, rt_stats=None) -> torch.Tensor:
        """``rt_stats``: optional (mean, std) overriding the baked statistics."""
        for fn, safe, takes_stats in steps:
            if not safe:
                images = _to_float(images)
            images = fn(images, rt_stats) if takes_stats else fn(images)
        return _to_float(images)

    apply.specs = list(specs or ())
    return apply
