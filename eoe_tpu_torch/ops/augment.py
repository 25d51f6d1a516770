"""The random crop step of a training pipeline as one pair of CUDA kernels,
and their plain PyTorch versions.

``crop_augment`` is the step ``ops.preprocess.compile_pipeline`` makes of a
random crop and the ops it takes in: the JAX package's peepholes
``color_jitter_crop_flip`` and ``random_crop_hflip``
(eoe_tpu/ops/preprocess.py:232-349, which XLA fuses with what follows), a
random crop alone, and the epilogue folded after them (identity resizes, the
clip_pil channel expansion of a one-channel crop, Gaussian noise, one
per-channel normalisation). On a CPU tensor it computes the composition of
the plain functions of ``ops.preprocess`` (``crop_augment_ref``); on a CUDA
tensor it launches the kernels of ``csrc/augment.cu`` (built at first use,
see ``_build``) or raises:

- ``crop_stats``: one pass over each raw image for the contrast mean (the
  luma of the full image after the brightness clip) and the crop's min and
  max, whose spread gives the degenerate verdict of ``_is_degenerate`` on
  the RAW crop; the guard alone reads only the crop windows. A cluster of
  ``stats_geometry`` blocks shares each image. It launches only where the
  step has a contrast factor or the guard is on.
- ``crop_apply``: one block per (image, band of output rows), the bands
  from ``apply_geometry``; each thread takes 4 consecutive output pixels of
  a row: the raw pixels at the crop's (flipped) position, zero padding and
  the degenerate fallback's centre window included, converted to fp32,
  jittered in the JAX package's order, then the epilogue; written in fp32.

The two have plain versions of their own (``crop_stats_ref``,
``crop_apply_ref``); ``crop_apply_ref(crop_stats_ref(...))`` is
``crop_augment_ref``. ``launches`` and ``stats_launches`` count the launches
of the apply and stats kernels.
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from eoe_tpu_torch.ops import _build
from eoe_tpu_torch.ops import preprocess as P

SOURCE = "augment.cu"
_DTYPE_CODES = {torch.uint8: 0, torch.float32: 1}
JITTER = ("brightness", "contrast", "saturation", "hue")

launches = 0          # apply kernel launches
stats_launches = 0    # stats kernel launches

Norm = Tuple[Sequence[float], Sequence[float]]


# ---------------------------------------------------------------- plain versions


def crop_stats_ref(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                   flip: Optional[torch.Tensor] = None, *, size: Tuple[int, int],
                   padding: int = 0, flip_first: bool = False,
                   brightness: Optional[torch.Tensor] = None, contrast: bool = False,
                   guard: bool = False) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(mean, degenerate): the (n,) contrast mean of ``P.contrast_mean`` where
    ``contrast``, the (n,) bool verdict of ``P._is_degenerate`` on the raw
    (zero-padded, flipped) crop where ``guard``; None for what is not asked."""
    mean = P.contrast_mean(images, brightness).reshape(-1) if contrast else None
    degenerate = None
    if guard:
        crop = P.random_crop_hflip(images, tops, lefts, flip, size, padding,
                                   flip_first=flip_first)
        degenerate = P._is_degenerate(crop)
    return mean, degenerate


def _epilogue(out: torch.Tensor, repeat: bool, noise: Optional[torch.Tensor],
              noise_std: float, norm: Optional[Norm]) -> torch.Tensor:
    if repeat and out.shape[-1] == 1:
        out = out.repeat(1, 1, 1, 3)
    if noise is not None:
        out = P.gaussian_noise(out, noise, noise_std)
    if norm is not None:
        out = P.normalize(out, norm[0], norm[1])
    return out


def crop_apply_ref(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                   flip: Optional[torch.Tensor], mean: Optional[torch.Tensor],
                   degenerate: Optional[torch.Tensor], *, size: Tuple[int, int],
                   padding: int = 0, flip_first: bool = False,
                   jitter: Optional[Dict[str, torch.Tensor]] = None, repeat: bool = False,
                   noise: Optional[torch.Tensor] = None, noise_std: float = 0.0,
                   norm: Optional[Norm] = None) -> torch.Tensor:
    """The crop (and flip) at the drawn offsets, the degenerate images' at
    their centre window, converted to float, jittered with the contrast
    ``mean`` given, then the epilogue."""
    out = P.random_crop_hflip(images, tops, lefts, flip, size, padding, flip_first=flip_first)
    if degenerate is not None:
        centre = P.center_window(P._pad(images, padding), size, flip, flip_first)
        out = torch.where(degenerate.reshape(-1, 1, 1, 1), centre, out)
    out = P._to_float(out)
    if jitter is not None:
        n = out.shape[0]
        out = P.color_jitter(out, **jitter, mean=None if mean is None else mean.reshape(n, 1, 1, 1))
    return _epilogue(out, repeat, noise, noise_std, norm)


def crop_augment_ref(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                     flip: Optional[torch.Tensor] = None, *, size: Tuple[int, int],
                     padding: int = 0, flip_first: bool = False, guard: bool = False,
                     jitter: Optional[Dict[str, torch.Tensor]] = None, repeat: bool = False,
                     noise: Optional[torch.Tensor] = None, noise_std: float = 0.0,
                     norm: Optional[Norm] = None) -> torch.Tensor:
    """Plain version of ``crop_augment``: the JAX package's peephole
    (``color_jitter_crop_flip`` with ``jitter``, else ``random_crop_hflip``)
    ported as ``ops.preprocess`` has it, then the epilogue."""
    if jitter is not None:
        out = P.color_jitter_crop_flip(images, tops, lefts, flip, size=size,
                                       resample_degenerate=guard, **jitter)
    else:
        out = P._to_float(P.random_crop_hflip(images, tops, lefts, flip, size, padding,
                                              guard, flip_first))
    return _epilogue(out, repeat, noise, noise_std, norm)


# ---------------------------------------------------------------- launch geometry

APPLY_THREADS = 256      # csrc/augment.cu kApplyThreads
MAX_CLUSTER = 8          # the portable cluster size
MAX_SMEM = 232448        # 227 KB, a block's most on sm_90
FILL_BLOCKS = 1024       # about eight blocks on each of the H100's 132 SMs
MIN_BLOCKS = 256         # apply: about two blocks on each SM before rows are halved
STATS_ROWS = 32          # rows a stats block takes before the cluster grows


class ApplyGeometry(NamedTuple):
    rows: int      # output rows a stage holds (a thread a quad of pixels of one)
    steps: int     # stages a band runs, double-buffered
    bands: int     # blocks per image (gridDim.y)
    pitch: int     # shared memory bytes of one staged source row
    smem: int      # dynamic shared memory of a block


def apply_geometry(n: int, th: int, tw: int, c: int, elem: int) -> ApplyGeometry:
    """The apply kernel's launch for n crops of th x tw from c-channel images
    of ``elem``-byte elements: as many rows a stage as a block has threads for
    their quads (4 pixels each; a ragged ``tw % 4`` tail goes scalar), halved
    while the grid would hold fewer than MIN_BLOCKS blocks (CIFAR-10's 128
    crops of 32 rows: two stages of 16); bands enough to put FILL_BLOCKS
    blocks on the card, at most 65,535 (gridDim.y). A staged row is the
    window's tw * c elements and the 16-byte hull around them; uint8 adds a
    256-entry table."""
    quads = -(-tw // 4)
    rows = max(1, min(th, APPLY_THREADS // quads))
    while rows > 1 and n * -(-th // rows) < MIN_BLOCKS:
        rows //= 2
    steps = -(-th // rows)                               # stages per image
    per_band = max(1, steps // max(1, -(-FILL_BLOCKS // n)), -(-steps // 65535))
    bands = -(-steps // per_band)
    pitch = (-(-(tw * c * elem) // 16) + 1) * 16
    smem = (256 * 4 if elem == 1 else 0) + 2 * rows * pitch
    return ApplyGeometry(rows, per_band, bands, pitch, smem)


def stats_geometry(h: int, th: int, contrast: bool) -> int:
    """The stats kernel's cluster size: blocks per image, each a band of at
    least STATS_ROWS of the rows it reads (all h for the contrast mean, the
    window's th for the guard alone), at most MAX_CLUSTER."""
    return max(1, min(MAX_CLUSTER, -(-(h if contrast else th) // STATS_ROWS)))


# ---------------------------------------------------------------- the kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C launchers' arguments on a loaded build of SOURCE."""
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.eoe_augment_stats.argtypes = [V, I, I, I, I, I, I, I, I, I, V, V, V, V, V, V, I, V]
    lib.eoe_augment_stats.restype = I
    lib.eoe_augment_apply.argtypes = ([V, I, I, I, I, I, I, I, I, I, V, V, V, V] + [V] * 5
                                      + [V, ctypes.c_float, V, V] + [I] * 5 + [V, V])
    lib.eoe_augment_apply.restype = I
    lib.eoe_cuda_error_string.argtypes = [I]
    lib.eoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.eoe_cuda_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _per_image(t: Optional[torch.Tensor], n: int, dtype: torch.dtype, what: str,
               device: torch.device) -> Optional[torch.Tensor]:
    """A draw of one value per image as the (n,) contiguous ``dtype`` vector
    the kernels read."""
    if t is None:
        return None
    if t.device != device or t.numel() != n:
        raise ValueError(f"crop_augment: {what} must hold {n} values on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.reshape(n).to(dtype).contiguous()


def _check_images(images: torch.Tensor, size: Tuple[int, int], padding: int):
    if not images.is_cuda:
        raise ValueError(f"crop_augment runs on CUDA or CPU tensors, got {images.device}")
    if images.dtype not in _DTYPE_CODES:
        raise ValueError(f"crop_augment takes uint8 or float32 images, got {images.dtype}")
    if images.dim() != 4 or images.shape[-1] not in (1, 3):
        raise ValueError(f"crop_augment takes NHWC images of 1 or 3 channels, got "
                         f"{tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("crop_augment needs contiguous images")
    _n, h, w, _c = images.shape
    if padding < 0 or not (0 < size[0] <= h + 2 * padding and 0 < size[1] <= w + 2 * padding):
        raise ValueError(f"crop_augment: a {size} crop of {h}x{w} images padded by {padding}")


def crop_stats(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
               flip: Optional[torch.Tensor] = None, *, size: Tuple[int, int],
               padding: int = 0, flip_first: bool = False,
               brightness: Optional[torch.Tensor] = None, contrast: bool = False,
               guard: bool = False) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The stats kernel on a CUDA tensor (``crop_stats_ref`` on a CPU one):
    (n,) fp32 contrast means where ``contrast``, (n,) bool degenerate flags
    where ``guard``."""
    global stats_launches
    if images.device.type == "cpu":
        return crop_stats_ref(images, tops, lefts, flip, size=size, padding=padding,
                              flip_first=flip_first, brightness=brightness, contrast=contrast,
                              guard=guard)
    _check_images(images, size, padding)
    n, h, w, c = images.shape
    dev = images.device
    tops = _per_image(tops, n, torch.int64, "tops", dev)
    lefts = _per_image(lefts, n, torch.int64, "lefts", dev)
    flip = _per_image(flip, n, torch.bool, "flip", dev)
    brightness = _per_image(brightness, n, torch.float32, "brightness", dev)
    mean = torch.empty(n, dtype=torch.float32, device=dev) if contrast else None
    degenerate = torch.empty(n, dtype=torch.bool, device=dev) if guard else None
    if mean is None and degenerate is None:
        return None, None
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.eoe_augment_stats(
            images.data_ptr(), _DTYPE_CODES[images.dtype], n, h, w, c, size[0], size[1],
            padding, int(flip_first), tops.data_ptr(), lefts.data_ptr(), _ptr(flip),
            _ptr(brightness), _ptr(mean), _ptr(degenerate),
            stats_geometry(h, size[0], contrast), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "crop_stats")
    stats_launches += 1
    return mean, degenerate


@functools.lru_cache(maxsize=64)
def _constants(values: Tuple[float, ...], device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _channel_values(v, cout: int, device: torch.device, what: str) -> torch.Tensor:
    """Per-channel statistics as the fp32 (cout,) vector the kernel reads, as
    ``P.normalize`` converts them."""
    if torch.is_tensor(v):
        t = v.to(device=device, dtype=torch.float32).reshape(-1).contiguous()
    else:
        t = _constants(tuple(float(x) for x in v), str(device))
    if t.numel() != cout:
        raise ValueError(f"crop_augment: normalisation {what} of {t.numel()} channels for "
                         f"{cout}-channel images")
    return t


def crop_apply(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
               flip: Optional[torch.Tensor], mean: Optional[torch.Tensor],
               degenerate: Optional[torch.Tensor], *, size: Tuple[int, int],
               padding: int = 0, flip_first: bool = False,
               jitter: Optional[Dict[str, torch.Tensor]] = None, repeat: bool = False,
               noise: Optional[torch.Tensor] = None, noise_std: float = 0.0,
               norm: Optional[Norm] = None) -> torch.Tensor:
    """The apply kernel on a CUDA tensor (``crop_apply_ref`` on a CPU one):
    (n, th, tw, cout) fp32, cout 3 where ``repeat`` expands one channel."""
    global launches
    kw = dict(size=size, padding=padding, flip_first=flip_first, jitter=jitter, repeat=repeat,
              noise=noise, noise_std=noise_std, norm=norm)
    if images.device.type == "cpu":
        return crop_apply_ref(images, tops, lefts, flip, mean, degenerate, **kw)
    _check_images(images, size, padding)
    n, h, w, c = images.shape
    th, tw = size
    cout = 3 if repeat else c
    dev = images.device
    jitter = jitter or {}
    unknown = sorted(set(jitter) - set(JITTER))
    if unknown:
        raise ValueError(f"crop_augment: unknown jitter factors {unknown}")
    if jitter and (padding or flip_first):
        raise ValueError("crop_augment: the jitter is fused into padding-0 crop -> flip "
                         "steps only")
    if "contrast" in jitter and mean is None:
        raise ValueError("crop_augment: a contrast factor needs the contrast mean")
    factors = [_per_image(jitter.get(k), n, torch.float32, k, dev) for k in JITTER]
    tops = _per_image(tops, n, torch.int64, "tops", dev)
    lefts = _per_image(lefts, n, torch.int64, "lefts", dev)
    flip = _per_image(flip, n, torch.bool, "flip", dev)
    degenerate = _per_image(degenerate, n, torch.bool, "degenerate", dev)
    mean = _per_image(mean, n, torch.float32, "mean", dev)
    if noise is not None:
        if noise.shape != (n, th, tw, cout) or noise.dtype != torch.float32 \
                or noise.device != dev or not noise.is_contiguous():
            raise ValueError(f"crop_augment: noise must be a contiguous fp32 {(n, th, tw, cout)} "
                             f"tensor on {dev}, got {noise.dtype} {tuple(noise.shape)}")
    norm_mean = norm_std = None
    if norm is not None:
        norm_mean = _channel_values(norm[0], cout, dev, "mean")
        norm_std = _channel_values(norm[1], cout, dev, "std")
    geo = apply_geometry(n, th, tw, c, images.element_size())
    if geo.smem > MAX_SMEM:
        raise ValueError(f"crop_augment: a {tw}-pixel crop row of {c} channels needs "
                         f"{geo.smem} bytes of shared memory, more than a block has")
    out = torch.empty((n, th, tw, cout), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.eoe_augment_apply(
            images.data_ptr(), _DTYPE_CODES[images.dtype], n, h, w, c, th, tw, padding,
            int(flip_first), tops.data_ptr(), lefts.data_ptr(), _ptr(flip), _ptr(degenerate),
            *map(_ptr, factors), _ptr(mean), _ptr(noise), float(noise_std), _ptr(norm_mean),
            _ptr(norm_std), cout, geo.rows, geo.steps, geo.bands, geo.pitch, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "crop_apply")
    launches += 1
    return out


def crop_augment(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                 flip: Optional[torch.Tensor] = None, *, size: Tuple[int, int],
                 padding: int = 0, flip_first: bool = False, guard: bool = False,
                 jitter: Optional[Dict[str, torch.Tensor]] = None, repeat: bool = False,
                 noise: Optional[torch.Tensor] = None, noise_std: float = 0.0,
                 norm: Optional[Norm] = None) -> torch.Tensor:
    """One random crop step: ``images`` (n, h, w, c) raw uint8 or float, the
    drawn ``tops``/``lefts`` (into the images padded by ``padding``) and
    ``flip`` bits (None: no flip; ``flip_first``: hflip -> crop, else crop
    -> hflip); ``guard`` the degenerate-crop fallback; ``jitter`` the
    drawn factors of a fused ``color_jitter`` (padding 0); ``repeat`` the
    clip_pil expansion of one channel to three; ``noise`` the drawn noise
    of the crop's output shape, added times ``noise_std``; ``norm`` the
    (mean, std) of a per-channel normalisation. Returns float (fp32 on the
    card). On a CUDA tensor: the stats kernel where a contrast factor or the
    guard asks for it, then the apply kernel; on a CPU tensor
    ``crop_augment_ref``."""
    if jitter is not None and (padding or flip_first):
        raise ValueError("crop_augment: the jitter is fused into padding-0 crop -> flip "
                         "steps only")
    if images.device.type == "cpu":
        return crop_augment_ref(images, tops, lefts, flip, size=size, padding=padding,
                                flip_first=flip_first, guard=guard, jitter=jitter,
                                repeat=repeat, noise=noise, noise_std=noise_std, norm=norm)
    jitter = jitter or None
    contrast = jitter is not None and "contrast" in jitter
    mean, degenerate = crop_stats(images, tops, lefts, flip, size=size, padding=padding,
                                  flip_first=flip_first,
                                  brightness=jitter.get("brightness") if contrast else None,
                                  contrast=contrast, guard=guard)
    return crop_apply(images, tops, lefts, flip, mean, degenerate, size=size, padding=padding,
                      flip_first=flip_first, jitter=jitter, repeat=repeat, noise=noise,
                      noise_std=noise_std, norm=norm)
