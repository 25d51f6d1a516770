"""Plain PyTorch training and test stacks of the EOE runners, applied with
given random draws.

A stack is the runner's list of specs. The draws are one dict per random
op, in spec order: ``color_jitter`` {brightness, contrast, saturation, hue}
(per-image factors, hue a shift), ``random_crop`` {tops, lefts} (offsets
into the padded image), ``random_hflip`` {flip} (bits), ``gaussian_noise``
{noise} (a tensor of the images' shape). Index-only ops (crops, flips,
identity resizes) act on the raw bytes; every other op on float images in
[0, 1] (bytes / 255); the result is float.

Semantics (those of the EOE JAX package, whose order of operations the
runners' results depend on):

* ``color_jitter`` directly followed by a padding-0 ``random_crop`` (and a
  ``random_hflip``): the contrast statistic is the luma mean of the whole
  image after the brightness clip, the crop (and flip) is taken from the
  raw image, the jitter applied to the crop; the degenerate-crop test looks
  at the raw crop;
* jitter: brightness ``clip(x * b)``, contrast ``clip(c x + (1 - c) mean)``,
  saturation ``clip(s x + (1 - s) luma)``, hue a shift of the HSV hue
  modulo 1; luma = 0.299 r + 0.587 g + 0.114 b;
* a crop whose pixels are all equal (max - min 0 for bytes, at most 1e-6
  for floats) is replaced by the centre crop of the same input, where the
  dataset asks for it (``guard``);
* resizes are antialiased bilinear, or bicubic for CLIP's, and pass an
  image of the target size through untouched;
* ``normalize`` takes the dataset's per-channel mean and unbiased standard
  deviation of the raw normal train split (``channel_stats``).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
RANDOM_OPS = ("color_jitter", "random_crop", "random_hflip", "gaussian_noise")


def _spec(s) -> dict:
    return {"op": s} if isinstance(s, str) else dict(s)


def random_ops(specs: Sequence) -> List[str]:
    return [_spec(s)["op"] for s in specs if _spec(s)["op"] in RANDOM_OPS]


def channel_stats(images: torch.Tensor, chunk: int = 256) -> Tuple[tuple, tuple]:
    """Per-channel mean and unbiased std of uint8 NHWC images / 255, in float64."""
    s1 = torch.zeros(images.shape[-1], dtype=torch.float64, device=images.device)
    s2 = torch.zeros_like(s1)
    for i in range(0, images.shape[0], chunk):
        x = images[i:i + chunk].double() / 255.0
        s1 += x.sum(dim=(0, 1, 2))
        s2 += x.square().sum(dim=(0, 1, 2))
    n = images[..., 0].numel()
    mean = s1 / n
    var = (s2 - n * mean.square()) / (n - 1)
    return tuple(mean.tolist()), tuple(var.sqrt().tolist())


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def _luma(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(dim=-1), x.amin(dim=-1)
    delta = mx - mn
    s = torch.where(mx > 0, delta / mx.clamp(min=1e-12), torch.zeros_like(mx))
    d = delta.clamp(min=1e-12)
    h = torch.where(r == mx, (g - b) / d,
                    torch.where(g == mx, 2.0 + (b - r) / d, 4.0 + (r - g) / d))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    out = []
    for n in (5.0, 3.0, 1.0):
        k = torch.remainder(n + 6.0 * h, 6.0)
        out.append(v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0))
    return torch.stack(out, dim=-1)


def jitter(x: torch.Tensor, d: Dict[str, torch.Tensor], mean: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    x = _float(x)
    if "brightness" in d:
        x = (x * d["brightness"]).clamp(0.0, 1.0)
    if "contrast" in d:
        if mean is None:
            mean = _luma(x).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
        x = (d["contrast"] * x + (1 - d["contrast"]) * mean).clamp(0.0, 1.0)
    if "saturation" in d:
        gray = _luma(x)[..., None]
        x = (d["saturation"] * x + (1 - d["saturation"]) * gray).clamp(0.0, 1.0)
    if "hue" in d:
        hsv = _rgb_to_hsv(x)
        hue = torch.remainder(hsv[..., 0] + d["hue"], 1.0)
        x = _hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))
    return x


def crop(x: torch.Tensor, tops, lefts, size: Tuple[int, int], padding: int, guard: bool
         ) -> torch.Tensor:
    if padding > 0:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    n = x.shape[0]
    th, tw = size
    out = torch.stack([x[i, int(tops[i]):int(tops[i]) + th, int(lefts[i]):int(lefts[i]) + tw]
                       for i in range(n)])
    if guard:
        spread = out.amax(dim=(1, 2, 3)) - out.amin(dim=(1, 2, 3))
        flat = spread <= (0 if out.dtype == torch.uint8 else 1e-6)
        out = torch.where(flat.reshape(-1, 1, 1, 1), centre_crop(x, size), out)
    return out


def centre_crop(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = x.shape[1:3]
    i, j = (h - size[0]) // 2, (w - size[1]) // 2
    return x[:, i:i + size[0], j:j + size[1]]


def hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip.reshape(-1, 1, 1, 1), x.flip(2), x)


def resize(x: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(_float(x).permute(0, 3, 1, 2), size=tuple(size), mode=mode,
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _size(s: dict) -> Tuple[int, int]:
    v = s["size"]
    return (v, v) if isinstance(v, int) else tuple(v)


def apply(images: torch.Tensor, specs: Sequence, draws: Sequence[dict], guard: bool = False,
          stats: Optional[Tuple[tuple, tuple]] = None) -> torch.Tensor:
    """``images`` (n, h, w, c) uint8 through ``specs`` with ``draws``; float out."""
    specs = [_spec(s) for s in specs]
    x, k, i = images, 0, 0
    while i < len(specs):
        s, op = specs[i], specs[i]["op"]
        nxt = specs[i + 1] if i + 1 < len(specs) else {}
        if op == "color_jitter" and nxt.get("op") == "random_crop" and not nxt.get("padding"):
            jd, cd = draws[k], draws[k + 1]
            k, i = k + 2, i + 2
            mean = None
            if "contrast" in jd:
                full = _float(x)
                if "brightness" in jd:
                    full = (full * jd["brightness"]).clamp(0.0, 1.0)
                mean = _luma(full).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
            x = crop(x, cd["tops"], cd["lefts"], _size(nxt), 0, nxt.get("resample_degenerate",
                                                                         guard))
            if i < len(specs) and specs[i]["op"] in ("random_hflip", "random_horizontal_flip"):
                x = hflip(x, draws[k]["flip"])
                k, i = k + 1, i + 1
            x = jitter(x, jd, mean)
            continue
        if op == "color_jitter":
            x = jitter(x, draws[k])
            k += 1
        elif op == "random_crop":
            x = crop(x, draws[k]["tops"], draws[k]["lefts"], _size(s), int(s.get("padding", 0)),
                     s.get("resample_degenerate", guard))
            k += 1
        elif op in ("random_hflip", "random_horizontal_flip"):
            x = hflip(x, draws[k]["flip"])
            k += 1
        elif op == "gaussian_noise":
            x = _float(x) + float(s["std"]) * draws[k]["noise"]
            k += 1
        elif op == "resize":
            x = resize(x, _size(s), "bicubic" if s.get("method") in ("cubic", "bicubic")
                       else "bilinear")
        elif op == "center_crop":
            x = centre_crop(x, _size(s))
        elif op == "clip_pil_preprocessing":
            r = int(s.get("resolution", 224))
            x = resize(x, (r, r), "bicubic")
        elif op == "clip_tensor_preprocessing":
            x = _normalise(_float(x), CLIP_MEAN, CLIP_STD)
        elif op in ("normalize", "normalise", "norm"):
            x = _normalise(_float(x), *stats)
        else:
            raise ValueError(f"the reference has no op {op!r}")
        i += 1
    assert k == len(draws), (k, len(draws))
    return _float(x)


def _normalise(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - m) / s
