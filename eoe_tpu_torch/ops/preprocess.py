"""Preprocessing and augmentation pipelines: the port of
eoe_tpu/ops/preprocess.py.

A pipeline is the same declarative list of specs (plain dicts / strings) the
JAX package records in setup.json and snapshots; ``compile_pipeline(specs,
stats)`` turns it into one batched function
``fn(images, rt_stats=None, *, generator=None, draws=None) -> images`` over
NHWC tensors, on whatever device the images lie on. uint8 inputs follow the JAX
order: index-only ops (crops, flips, identity resizes) run on the bytes, a
real resize converts to float (/255) first, every other op converts first,
and the result is converted once more at the end.

Each random op is a draw and an apply. The draws (jitter factors, crop
offsets, flip bits, the noise tensor) come from ``generator``, a
``torch.Generator`` on the images' device, in spec order, as the JAX pipeline
hands ``keys[i]`` to its i-th random op; ``draws`` replaces them by given
tensors (one dict per random op, see ``fn.random_ops``), so a test can inject
the JAX package's draws. ``fn.draw(images, rt_stats, generator=...)`` makes
the draws alone, in the same order and from the same generator calls as
``fn`` would (the shapes each draw sees come from one image taken through
the steps once per input shape, with draws of a generator of its own), so
that a caller can draw for several batches and apply once to their
concatenation: every op works on each image alone.

The JAX package's peepholes are taken under its conditions, read when the
pipeline is compiled: ``color_jitter`` followed by a padding-0
``random_crop`` (and a ``random_hflip``) becomes ``color_jitter_crop_flip``
unless ``EOE_TPU_FUSE_JITTER_CROP=0``; ``random_crop`` next to
``random_hflip``, in either order, becomes ``random_crop_hflip``. The first
is not the unfused composition: its degenerate-crop guard tests the raw
crop, the unfused order the jittered one (they differ where the brightness
clip makes a near-white crop constant). Every random crop, fused or alone,
runs as one step of ``ops.augment``, with the run of identity resizes,
noise and one normalisation that follows it folded in: on the card the
augmentation kernels, on the CPU the plain functions of this module. A fused
step makes the same draws, from the same generator calls, as the unfused
steps would: one dict per random op, in spec order.

Resizes use ``F.interpolate`` with ``antialias=True``: that matches
``jax.image.resize`` ("cubic" -> bicubic, "linear" -> bilinear) to ~1e-6
for both up- and downscaling, where ``antialias=False`` misses by 0.1-0.2
(tests/test_torch_preprocess.py).

The filters (grayscale, blur, sharpen, hpf, lpf, minmax_norm, gcn and the
``gcn-normalize`` placeholder: GCN-l1, then the statistics) are
``ops.filters``. ``compile_conditional`` compiles label-conditional
pipelines, the multi-scale modes' (MSM) filters on one dataset part.
"""

import dataclasses
import json
import os
from functools import lru_cache, partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from eoe_tpu_torch.ops import filters as Fil

Spec = Union[str, Dict[str, Any]]

# CLIP's canonical normalization constants (public, from OpenAI CLIP preprocessing)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

NORM_PLACEHOLDERS = ("norm", "normalise", "normalize")
GCN_PLACEHOLDERS = ("gcn-norm", "gcn-normalize", "gcn-normalise")
HFLIP_OPS = ("random_hflip", "random_horizontal_flip")
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


# ---------------------------------------------------------------- color ops


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    deltac = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, deltac / maxc.clamp(min=1e-12), zero)
    dc = deltac.clamp(min=1e-12)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]

    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def _luma(img: torch.Tensor) -> torch.Tensor:
    if img.shape[-1] == 1:
        return img[..., 0]
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _uniform(n: int, shape, lo: float, hi: float, like: torch.Tensor,
             g: torch.Generator) -> torch.Tensor:
    u = torch.rand((n, *shape), generator=g, device=like.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def draw_color_jitter(images: torch.Tensor, g: torch.Generator, brightness: float = 0.0,
                      contrast: float = 0.0, saturation: float = 0.0,
                      hue: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per-sample factors, sampled like torchvision: (n,1,1,1) brightness,
    contrast and saturation factors, an (n,1,1) hue shift; only those > 0."""
    n, color = images.shape[0], images.shape[-1] == 3
    out = {}
    if brightness > 0:
        out["brightness"] = _uniform(n, (1, 1, 1), max(0.0, 1 - brightness), 1 + brightness,
                                     images, g)
    if contrast > 0:
        out["contrast"] = _uniform(n, (1, 1, 1), max(0.0, 1 - contrast), 1 + contrast, images, g)
    if saturation > 0 and color:
        out["saturation"] = _uniform(n, (1, 1, 1), max(0.0, 1 - saturation), 1 + saturation,
                                     images, g)
    if hue > 0 and color:
        out["hue"] = _uniform(n, (1, 1), -hue, hue, images, g)
    return out


def color_jitter(images: torch.Tensor, brightness: Optional[torch.Tensor] = None,
                 contrast: Optional[torch.Tensor] = None,
                 saturation: Optional[torch.Tensor] = None,
                 hue: Optional[torch.Tensor] = None,
                 mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply drawn jitter factors in the JAX package's fixed order
    (brightness, contrast, saturation, hue). ``mean``: the (n,1,1,1)
    contrast statistic when it was taken elsewhere (over the full image,
    for a crop); by default the luma mean of ``images`` after brightness."""
    n = images.shape[0]
    if brightness is not None:
        images = (images * brightness).clamp(0.0, 1.0)
    if contrast is not None:
        if mean is None:
            mean = _luma(images).mean(dim=(1, 2)).reshape(n, 1, 1, 1)
        images = (contrast * images + (1 - contrast) * mean).clamp(0.0, 1.0)
    if saturation is not None and images.shape[-1] == 3:
        gray = _luma(images)[..., None]
        images = (saturation * images + (1 - saturation) * gray).clamp(0.0, 1.0)
    if hue is not None and images.shape[-1] == 3:
        hsv = _rgb_to_hsv(images)
        h = torch.remainder(hsv[..., 0] + hue, 1.0)
        images = _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return images


# ---------------------------------------------------------------- geometric ops


def _pad(images: torch.Tensor, padding: int) -> torch.Tensor:
    if padding <= 0:
        return images
    return F.pad(images, (0, 0, padding, padding, padding, padding))


def draw_random_crop(images: torch.Tensor, g: torch.Generator, size: Tuple[int, int],
                     padding: int = 0, **_) -> Dict[str, torch.Tensor]:
    """(n,) top and left offsets into the padded images."""
    n, h, w, _c = images.shape
    h, w = h + 2 * max(padding, 0), w + 2 * max(padding, 0)
    th, tw = size
    return {"tops": torch.randint(0, h - th + 1, (n,), generator=g, device=images.device),
            "lefts": torch.randint(0, w - tw + 1, (n,), generator=g, device=images.device)}


def _is_degenerate(out: torch.Tensor) -> torch.Tensor:
    """Per-sample constancy: max - min over the image, 0 for uint8 and at most
    1e-6 for floats (the reference re-draws crops whose std is < 1e-15)."""
    spread = out.amax(dim=(1, 2, 3)) - out.amin(dim=(1, 2, 3))
    return spread <= (0 if out.dtype == torch.uint8 else 1e-6)


def center_window(images: torch.Tensor, size: Tuple[int, int],
                  flip: Optional[torch.Tensor] = None,
                  flip_first: bool = False) -> torch.Tensor:
    """The crop a degenerate crop falls back to: the centre crop of the
    (padded) images; where ``flip`` is set, as the flipped composition
    leaves it: crop -> flip flips the centre window in place, flip -> crop
    takes the mirrored centre window reversed (one column apart where
    ``w - tw`` is odd)."""
    n, h, w, _c = images.shape
    th, tw = size
    center = center_crop(images, size)
    if flip is None:
        return center
    if flip_first:
        ci, cj2 = (h - th) // 2, (w - tw) - (w - tw) // 2
        alt = images[:, ci:ci + th, cj2:cj2 + tw, :].flip(2)
    else:
        alt = center.flip(2)
    return torch.where(flip.reshape(n, 1, 1, 1), alt, center)


def _degenerate_to_center(out: torch.Tensor, images: torch.Tensor, size: Tuple[int, int],
                          flip: Optional[torch.Tensor] = None,
                          flip_first: bool = False) -> torch.Tensor:
    """Replace degenerate (constant) crops by ``center_window``: the
    fixed-shape stand-in for the reference's re-draw
    (eoe_tpu/ops/preprocess.py:209-229)."""
    degenerate = _is_degenerate(out).reshape(-1, 1, 1, 1)
    return torch.where(degenerate, center_window(images, size, flip, flip_first), out)


def _crop_columns(lefts: torch.Tensor, flip: Optional[torch.Tensor], tw: int, w: int,
                  flip_first: bool) -> torch.Tensor:
    """(n, tw) source columns of a crop of width ``tw`` from images of width
    ``w``, the flip folded in: flip(crop(x))[:, j] = x[:, left + (tw-1-j)],
    crop(flip(x))[:, j] = x[:, (w-1) - left - j]."""
    j = torch.arange(tw, device=lefts.device)
    lefts = lefts.reshape(-1, 1)
    if flip is None:
        return lefts + j
    flip = flip.reshape(-1, 1)
    if flip_first:
        return torch.where(flip, (w - 1) - lefts - j, lefts + j)
    return lefts + torch.where(flip, tw - 1 - j, j)


def random_crop_hflip(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                      flip: Optional[torch.Tensor], size: Tuple[int, int], padding: int = 0,
                      resample_degenerate: bool = False,
                      flip_first: bool = False) -> torch.Tensor:
    """``random_crop`` and ``random_hflip`` as one gather on the raw dtype
    (eoe_tpu/ops/preprocess.py:232-266): the flip reverses each flipped
    image's crop columns. ``flip_first`` is the hflip -> crop order,
    otherwise crop -> hflip; ``flip`` None crops alone. The same as the
    unfused ops, degenerate fallback included."""
    images = _pad(images, padding)
    n, _h, w, _c = images.shape
    th, tw = size
    rows = tops.reshape(n, 1) + torch.arange(th, device=images.device)
    cols = _crop_columns(lefts, flip, tw, w, flip_first)
    batch = torch.arange(n, device=images.device).reshape(n, 1, 1)
    out = images[batch, rows[:, :, None], cols[:, None, :]]
    if resample_degenerate:
        out = _degenerate_to_center(out, images, size, flip, flip_first)
    return out


def random_crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                size: Tuple[int, int], padding: int = 0,
                resample_degenerate: bool = False) -> torch.Tensor:
    """Per-sample crop at the drawn offsets, after optional zero padding, as
    one gather. ``resample_degenerate``: a constant crop falls back to the
    centre crop, the fixed-shape stand-in for the reference's re-draw."""
    return random_crop_hflip(images, tops, lefts, None, size, padding, resample_degenerate)


def draw_random_hflip(images: torch.Tensor, g: torch.Generator, p: float = 0.5
                      ) -> Dict[str, torch.Tensor]:
    """(n,) flip bits, each set with probability ``p``."""
    u = torch.rand(images.shape[0], generator=g, device=images.device)
    return {"flip": u < p}


def random_hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip.reshape(-1, 1, 1, 1), images.flip(2), images)


def contrast_mean(images: torch.Tensor,
                  brightness: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,1,1,1) luma mean of the full images after the brightness clip:
    the contrast statistic of ``color_jitter_crop_flip``."""
    full = _to_float(images)
    if brightness is not None:
        full = (full * brightness).clamp(0.0, 1.0)
    return _luma(full).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)


def color_jitter_crop_flip(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                           flip: Optional[torch.Tensor] = None, *, size: Tuple[int, int],
                           resample_degenerate: bool = False,
                           brightness: Optional[torch.Tensor] = None,
                           contrast: Optional[torch.Tensor] = None,
                           saturation: Optional[torch.Tensor] = None,
                           hue: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``color_jitter`` -> padding-0 ``random_crop`` [-> ``random_hflip``]
    as the JAX package fuses them (eoe_tpu/ops/preprocess.py:281-349): the
    contrast mean over the full image after the brightness clip, the crop
    (and flip) gathered on the raw dtype, the jitter applied at crop size.
    ``resample_degenerate`` tests the RAW crop, where the unfused order tests
    the jittered one; a degenerate crop's centre window is jittered with the
    same factors."""
    mean = contrast_mean(images, brightness) if contrast is not None else None
    out = _to_float(random_crop_hflip(images, tops, lefts, flip, size,
                                      resample_degenerate=resample_degenerate))
    return color_jitter(out, brightness, contrast, saturation, hue, mean=mean)


def draw_gaussian_noise(images: torch.Tensor, g: torch.Generator) -> Dict[str, torch.Tensor]:
    return {"noise": torch.randn(images.shape, generator=g, device=images.device,
                                 dtype=images.dtype)}


def gaussian_noise(images: torch.Tensor, noise: torch.Tensor, std: float) -> torch.Tensor:
    """Additive Gaussian noise (the reference's Noise transform)."""
    return images + std * noise


@lru_cache(maxsize=64)
def _constant(values: Tuple[float, ...], dtype: torch.dtype, device: str) -> torch.Tensor:
    """Per-channel constants on ``device``, copied there once: a training
    step captured as a CUDA graph may not copy from the host."""
    return torch.tensor(values, dtype=dtype, device=device)


def _channels(v, like: torch.Tensor) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    return _constant(tuple(float(x) for x in v), like.dtype, str(like.device))


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    return (images - _channels(mean, images)) / _channels(std, images)


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


def _rows(n: int, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A stand-in of ``n`` images of ``shape``: what a draw reads of its
    images (their count, shape, dtype and device), without their memory."""
    return torch.zeros((), dtype=dtype, device=device).expand(n, *shape)


def _draw_inputs(cache: dict, images: torch.Tensor, run: Callable) -> list:
    """(shape, dtype) of what each draw of a compiled function sees, from
    one image taken through it once per input shape: ``run(x, generator,
    record)`` applies the function, calling ``record`` on the input of
    each stage that draws. ``images`` may be a stand-in without memory
    (``_rows``); the image taken through is a copy with its own, which the
    card's crop kernel needs."""
    key = (tuple(images.shape[1:]), images.dtype, images.device)
    if key not in cache:
        out = []
        run(images[:1].contiguous(), torch.Generator(device=images.device),
            lambda x: out.append((tuple(x.shape[1:]), x.dtype)))
        cache[key] = out
    return cache[key]


@dataclasses.dataclass
class _Step:
    fn: Optional[Callable]              # apply(images, **draws) for random steps; None
                                        # for a random crop, which its _CropStep applies
    u8_safe: bool = False               # runs on raw uint8 bytes
    takes_stats: bool = False           # receives the runtime (mean, std)
    draw: Optional[Callable] = None     # draw(images, generator) -> dict; random steps
    op: str = ""
    # what a crop step may fold in: ("identity", size), ("clip_pil", size),
    # ("noise", std) or ("norm", mean, std, takes runtime stats)
    fold: tuple = ()


def _crop_kw(s: Dict[str, Any], degenerate_crop_guard: bool) -> Dict[str, Any]:
    return dict(size=_size(s), padding=int(s.get("padding", 0) or 0),
                resample_degenerate=bool(s.get("resample_degenerate", degenerate_crop_guard)))


def _spec_steps(s: Dict[str, Any], stats: Optional[DatasetStats],
                degenerate_crop_guard: bool) -> List[_Step]:
    """The steps of one spec, unfused."""
    op = s["op"].lower()
    if op in ("to_tensor", "totensor", "rgb"):
        return []  # images are already NHWC
    if op == "resize":
        return [_Step(partial(_resize_u8, size=_size(s), method=s.get("method", "linear")),
                      u8_safe=True, op=op, fold=("identity", _size(s)))]
    if op == "center_crop":
        return [_Step(partial(center_crop, size=_size(s)), u8_safe=True, op=op)]
    if op == "random_crop":
        kw = _crop_kw(s, degenerate_crop_guard)
        return [_Step(None, u8_safe=True, draw=partial(draw_random_crop, **kw), op=op)]
    if op in HFLIP_OPS:
        return [_Step(random_hflip, u8_safe=True,
                      draw=partial(draw_random_hflip, p=float(s.get("p", 0.5))), op=op)]
    if op == "color_jitter":
        kw = {k: float(s.get(k, 0.0)) for k in ("brightness", "contrast", "saturation", "hue")}
        return [_Step(color_jitter, draw=partial(draw_color_jitter, **kw), op=op)]
    if op == "gaussian_noise":
        return [_Step(partial(gaussian_noise, std=float(s["std"])), draw=draw_gaussian_noise,
                      op=op, fold=("noise", float(s["std"])))]
    if op == "clip_pil_preprocessing":
        res = int(s.get("resolution", 224))
        return [_Step(partial(_clip_pil, res=res), u8_safe=True, op=op,
                      fold=("clip_pil", (res, res)))]
    if op == "clip_tensor_preprocessing":
        return [_Step(partial(normalize, mean=CLIP_MEAN, std=CLIP_STD), op=op,
                      fold=("norm", CLIP_MEAN, CLIP_STD, False))]
    if op == "normalize_with":
        mean, std = tuple(s["mean"]), tuple(s["std"])
        return [_Step(partial(normalize, mean=mean, std=std), op=op,
                      fold=("norm", mean, std, False))]
    filters = {"grayscale": lambda: Fil.grayscale,
               "blur": lambda: partial(Fil.gaussian_blur, sigma=float(s["sigma"])),
               "sharpen": lambda: partial(Fil.unsharp_mask, percent=float(s["percent"])),
               "hpf": lambda: partial(Fil.high_pass_filter, magnitude=int(s["magnitude"])),
               "lpf": lambda: partial(Fil.low_pass_filter, magnitude=int(s["magnitude"])),
               "minmax_norm": lambda: Fil.minmax_norm,
               "gcn": lambda: partial(Fil.global_contrast_normalization,
                                      scale=s.get("scale", "l1"))}
    if op in filters:
        return [_Step(filters[op](), op=op)]
    if op in NORM_PLACEHOLDERS + GCN_PLACEHOLDERS:
        if stats is None:
            raise PipelineError(
                f"pipeline contains {op!r} but no dataset statistics were provided; "
                "they are extracted from the raw normal train split")
        steps = []
        if op in GCN_PLACEHOLDERS:
            steps.append(_Step(partial(Fil.global_contrast_normalization, scale="l1"), op="gcn"))
        steps.append(_Step(partial(_normalize_rt, mean=stats.mean, std=stats.std),
                           takes_stats=True, op=op, fold=("norm", stats.mean, stats.std, True)))
        return steps
    if op == "lambda":
        raise PipelineError("arbitrary lambdas are not serializable; add a named op instead")
    raise PipelineError(f"unknown transform op: {op!r} (spec {s!r})")


def _peephole(specs: List[Dict[str, Any]], i: int) -> Optional[Tuple[str, int, bool]]:
    """(name, number of specs, flip first) of the crop step that starts at
    spec ``i``, or None. The JAX package's peepholes under its conditions
    (eoe_tpu/ops/preprocess.py:438-480), then a random crop alone."""
    op = specs[i]["op"].lower()
    nxt = specs[i + 1] if i + 1 < len(specs) else {}
    nxt_op = str(nxt.get("op", "")).lower()
    if (op == "color_jitter" and nxt_op == "random_crop"
            and int(nxt.get("padding", 0) or 0) == 0
            and os.environ.get("EOE_TPU_FUSE_JITTER_CROP", "1") != "0"):
        nxt2 = specs[i + 2] if i + 2 < len(specs) else {}
        return "color_jitter_crop_flip", (3 if str(nxt2.get("op", "")).lower() in HFLIP_OPS
                                          else 2), False
    if op == "random_crop" and nxt_op in HFLIP_OPS:
        return "random_crop_hflip", 2, False
    if op in HFLIP_OPS and nxt_op == "random_crop":
        return "random_crop_hflip", 2, True
    if op == "random_crop":
        return "random_crop", 1, False
    return None


def _fold_stage(steps: List[_Step], stage: int, size: Tuple[int, int]) -> Optional[int]:
    """Whether a crop step takes one more spec's ``steps`` into its
    epilogue, in the kernel's order: identity resizes anywhere, an identity
    ``clip_pil_preprocessing`` before the noise, one noise, one
    normalisation. The stage after them (0 before the noise, 1 after it, 2
    after the normalisation), or None where they end the fold."""
    for st in steps:
        kind = st.fold[0] if st.fold else None
        if kind == "identity" and st.fold[1] == size:
            continue
        if kind == "clip_pil" and st.fold[1] == size and stage == 0:
            continue
        if kind == "noise" and stage == 0:
            stage = 1
        elif kind == "norm" and stage < 2:
            stage = 2
        else:
            return None
    return stage


@dataclasses.dataclass
class _CropStep:
    """A random crop with what the JAX package fuses into it (a jitter before
    it, a flip on either side) and the epilogue folded after it: one call of
    ``augment.crop_augment`` on the raw images."""
    name: str                   # the JAX peephole it stands for, or "random_crop"
    parts: List[_Step]          # the fused ops' steps, in spec order
    epilogue: List[_Step]       # the folded steps after them
    crop: Dict[str, Any]        # size, padding, resample_degenerate
    flip_first: bool

    @property
    def random(self) -> List[_Step]:
        return [st for st in self.parts + self.epilogue if st.draw is not None]

    def __call__(self, images: torch.Tensor, rt_stats, generator, draws,
                 record: Optional[Callable]) -> torch.Tensor:
        from eoe_tpu_torch.ops import augment   # its plain version calls this module
        n, h, w, c = images.shape
        size = self.crop["size"]
        fdt = torch.float32 if images.dtype == torch.uint8 else images.dtype
        jitter = self.parts[0].op == "color_jitter"
        crop_dt = fdt if jitter else images.dtype
        folds = [st.fold for st in self.epilogue]
        repeat = c == 1 and any(f[0] == "clip_pil" for f in folds)
        # what each draw would see unfused: its op's input shape and dtype
        seen = {"color_jitter": ((h, w, c), fdt), "random_crop": ((h, w, c), crop_dt),
                "random_hflip": ((h, w, c) if self.flip_first else (*size, c), crop_dt),
                "gaussian_noise": ((*size, 3 if repeat else c), fdt)}
        got = {}
        for k, st in enumerate(self.random):
            op = "random_hflip" if st.op in HFLIP_OPS else st.op
            x = _rows(n, *seen[op], images.device)
            if record is not None:
                record(x)
            got[op] = draws[k] if draws is not None else st.draw(x, generator)
        noise, noise_std, norm = None, 0.0, None
        for f in folds:
            if f[0] == "noise":
                noise, noise_std = got["gaussian_noise"]["noise"], f[1]
            elif f[0] == "norm":
                norm = rt_stats if f[3] and rt_stats is not None else f[1:3]
        return augment.crop_augment(
            images, got["random_crop"]["tops"], got["random_crop"]["lefts"],
            got.get("random_hflip", {}).get("flip"), size=size, padding=self.crop["padding"],
            flip_first=self.flip_first, guard=self.crop["resample_degenerate"],
            jitter=got["color_jitter"] if jitter else None, repeat=repeat, noise=noise,
            noise_std=noise_std, norm=norm)


def compile_pipeline(specs: Sequence[Spec], stats: Optional[DatasetStats] = None,
                     degenerate_crop_guard: bool = False) -> Callable[..., torch.Tensor]:
    """Compile transform specs into one batched function
    ``fn(images, rt_stats=None, *, generator=None, draws=None) -> images``
    (NHWC in, NHWC float out). ``generator`` is needed when a spec is random, unless
    ``draws`` gives the draws. ``degenerate_crop_guard``: the default of
    ``random_crop``'s ``resample_degenerate``. ``fn.fused`` lists each crop
    step: the peephole it stands for, the ops it fuses in spec order, and the
    ops folded after it."""
    canon = [{"op": raw} if isinstance(raw, str) else dict(raw) for raw in specs or ()]
    per_spec = [_spec_steps(s, stats, degenerate_crop_guard) for s in canon]
    steps: List[Union[_Step, _CropStep]] = []
    i = 0
    while i < len(canon):
        head = _peephole(canon, i)
        if head is None:
            steps.extend(per_spec[i])
            i += 1
            continue
        name, k, flip_first = head
        crop = next(s for s in canon[i:i + k] if s["op"].lower() == "random_crop")
        crop = _crop_kw(crop, degenerate_crop_guard)
        parts = [st for p in per_spec[i:i + k] for st in p]
        i += k
        epilogue, stage = [], 0
        while i < len(canon):
            stage = _fold_stage(per_spec[i], stage, crop["size"])
            if stage is None:
                break
            epilogue.extend(per_spec[i])
            i += 1
        steps.append(_CropStep(name, parts, epilogue, crop, flip_first))
    random_steps = [st for step in steps
                    for st in (step.random if isinstance(step, _CropStep) else [step])
                    if st.draw is not None]
    random_ops = [st.op for st in random_steps]

    def apply(images: torch.Tensor, rt_stats=None, *,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
              record: Optional[Callable] = None) -> torch.Tensor:
        """``rt_stats``: optional (mean, std) overriding the baked statistics;
        ``draws``: one dict of drawn tensors per random op, in spec order;
        ``record`` is called on each random op's input (a stand-in of its
        shape and dtype inside a crop step)."""
        if random_ops and generator is None and draws is None:
            raise PipelineError("pipeline contains random ops but no generator was passed")
        ki = 0
        for st in steps:
            if isinstance(st, _CropStep):
                k = len(st.random)
                images = st(images, rt_stats, generator,
                            draws[ki:ki + k] if draws is not None else None, record)
                ki += k
                continue
            if not st.u8_safe:
                images = _to_float(images)
            if st.draw is not None:
                if record is not None:
                    record(images)
                d = draws[ki] if draws is not None else st.draw(images, generator)
                ki += 1
                images = st.fn(images, **d)
            elif st.takes_stats:
                images = st.fn(images, rt_stats)
            else:
                images = st.fn(images)
        return _to_float(images)

    traced: Dict[tuple, list] = {}

    def draw(images: torch.Tensor, rt_stats=None, *,
             generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
        """The draws ``apply`` would make for ``images``, without applying."""
        inputs = _draw_inputs(traced, images, lambda x, g, record: apply(
            x, rt_stats, generator=g, record=record))
        return [st.draw(_rows(images.shape[0], shape, dtype, images.device), generator)
                for st, (shape, dtype) in zip(random_steps, inputs)]

    apply.specs = list(specs or ())
    apply.random_ops = random_ops
    apply.fused = [(st.name, [p.op for p in st.parts], [e.op for e in st.epilogue])
                   for st in steps if isinstance(st, _CropStep)]
    apply.draw = draw
    return apply


def compile_conditional(conditionals: Sequence, stats: Optional[DatasetStats] = None,
                        degenerate_crop_guard: bool = False) -> Callable[..., torch.Tensor]:
    """Compile label-conditional transforms, a list of ``(cond, specs_eq,
    specs_neq)``, into ``fn(images, labels, rt_stats=None, *, generator=None,
    draws=None)``. As in the JAX package, both branches run on the whole
    batch and merge with ``torch.where`` on ``labels == cond``, one
    conditional after another; uint8 images convert to float first, unless
    the list is empty: then the images pass through as they came, so the
    main pipeline's index-only prefix still runs on the bytes. Random specs
    in a branch draw in spec order, the first branch's before the second's
    (``fn.random_ops``; ``draws`` gives one dict per random op)."""
    compiled = [(cond, compile_pipeline(t1 or [], stats, degenerate_crop_guard),
                 compile_pipeline(t2 or [], stats, degenerate_crop_guard))
                for cond, t1, t2 in (conditionals or ())]
    random_ops = [op for _, f1, f2 in compiled for op in f1.random_ops + f2.random_ops]

    def apply(images: torch.Tensor, labels: torch.Tensor, rt_stats=None, *,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
              record: Optional[Callable] = None) -> torch.Tensor:
        if compiled:
            images = _to_float(images)
        ki = 0
        for cond, f1, f2 in compiled:
            if record is not None:   # each conditional's input
                record(images)
            branches = []
            for f in (f1, f2):
                k = len(f.random_ops)
                d = draws[ki:ki + k] if draws is not None else None
                ki += k
                branches.append(f(images, rt_stats, generator=generator, draws=d))
            images = torch.where(labels.reshape(-1, 1, 1, 1) == cond, *branches)
        return images

    traced: Dict[tuple, list] = {}

    def draw(images: torch.Tensor, rt_stats=None, *,
             generator: torch.Generator) -> List[Dict[str, torch.Tensor]]:
        """The draws ``apply`` would make for ``images``, without applying."""
        inputs = _draw_inputs(traced, images, lambda x, g, record: apply(
            x, torch.zeros(1, device=x.device), rt_stats, generator=g, record=record))
        n, out = images.shape[0], []
        for (_, f1, f2), (shape, dtype) in zip(compiled, inputs):
            for f in (f1, f2):
                out.extend(f.draw(_rows(n, shape, dtype, images.device), rt_stats,
                                  generator=generator))
        return out

    apply.random_ops = random_ops
    apply.draw = draw
    return apply


def specs_repr(specs: Sequence[Spec]) -> str:
    """The canonical string of a spec list, as setup.json matching compares it."""
    return json.dumps([{"op": s} if isinstance(s, str) else dict(s) for s in (specs or ())],
                      sort_keys=True)
