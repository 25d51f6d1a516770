"""Bytes of one call of the augmentation pair (the stats and the apply
kernel of a random-crop step, taken as one operation), each input byte
read once and each output byte written once, whatever the kernels read
again: the raw crop window (``chip_smoke.py:794-800``, ``_window_bytes``:
the zero padding is not read), or the whole raw image where the contrast
statistic needs its luma mean; the noise tensor where the step adds noise;
the float output. The per-image draws (offsets, bits, factors) are a few
bytes and left out. The pair does no products: bytes bound it."""


def pair_bytes(n: int, raw: int, crop: int, channels: int, raw_elem: int, out_elem: int,
               contrast: bool, noise: bool) -> int:
    read = (raw * raw if contrast else crop * crop) * channels * raw_elem
    out = crop * crop * channels * out_elem
    return n * (read + out + (out if noise else 0))


def stack_shape(specs) -> tuple:
    """(crop side, whether a contrast factor needs the whole image's mean,
    whether noise is added) of a training stack's random crop step."""
    specs = [{"op": s} if isinstance(s, str) else s for s in specs]
    crop = next(s["size"] for s in specs if s["op"] == "random_crop")
    contrast = any(s["op"] == "color_jitter" and s.get("contrast", 0) > 0 for s in specs)
    noise = any(s["op"] == "gaussian_noise" for s in specs)
    return crop, contrast, noise
