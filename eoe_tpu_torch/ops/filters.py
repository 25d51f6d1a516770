"""Batched image filters over NHWC float tensors in [0, 1], on the tensor's
device: the port of eoe_tpu/ops/filters.py.

  gaussian_blur  -- kornia-style gaussian_blur2d: reflect padding, an odd
                    kernel k = 2*int(int(sigma/2)+0.5)+1 clamped to the image
                    (``kornia_kernel_size``), as two separable depthwise
                    convolutions (horizontal, then vertical)
  unsharp_mask   -- PIL's UnsharpMask(percent, radius=2): img + percent/100 *
                    (img - blur(img)), clipped to [0, 1]; its 9-tap kernel is
                    fixed, not clamped
  hpf / lpf      -- DFT filters: zero the centred (high-pass) or border
                    (low-pass) band of the fftshifted spectrum, then min-max
                    renormalise. At a magnitude of at least half the side
                    every frequency is zeroed and the result is 0/0 = NaN, as
                    in the JAX package
  gcn            -- per-sample global contrast normalisation (l1 or l2)
  minmax_norm    -- per-sample min-max to [0, 1]
  grayscale      -- channel mean, one channel kept

The JAX package computes these in XLA; here the convolutions are cuDNN's
and the transforms cuFFT's (pocketfft on the CPU).
"""

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, k: int, like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(k, dtype=torch.float32, device=like.device) - (k - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).to(like.dtype)


def kornia_kernel_size(sigma: float, image_size: int) -> int:
    """k = 2*int(int(sigma/2)+0.5)+1, clamped to [3, 2*int(int(S/2)+0.5)-1]."""
    k = 2 * int(int(sigma / 2) + 0.5) + 1
    return max(min(k, 2 * int(int(image_size / 2) + 0.5) - 1), 3)


def gaussian_blur(images: torch.Tensor, sigma: float, kernel_size: int = None) -> torch.Tensor:
    """Separable depthwise gaussian blur with reflect padding (kornia's)."""
    if sigma <= 0:
        return images
    n, h, w, c = images.shape
    k = kernel_size if kernel_size is not None else kornia_kernel_size(sigma, w)
    g = _gaussian_kernel1d(sigma, k, images)
    pad = k // 2
    x = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, g.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    x = F.conv2d(x, g.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return x.permute(0, 2, 3, 1)


def unsharp_mask(images: torch.Tensor, percent: float, radius: float = 2.0) -> torch.Tensor:
    """PIL-style unsharp mask: img + percent/100 * (img - blur(img)), clipped."""
    if percent <= 0:
        return images
    blurred = gaussian_blur(images, radius, kernel_size=2 * int(radius) * 2 + 1)
    return (images + (percent / 100.0) * (images - blurred)).clamp(0.0, 1.0)


def minmax_norm(images: torch.Tensor) -> torch.Tensor:
    """Per sample over all pixels and channels: subtract the min, then divide
    by the max of the shifted image."""
    flat = images.reshape(images.shape[0], -1)
    flat = flat - flat.amin(dim=1, keepdim=True)
    return (flat / flat.amax(dim=1, keepdim=True)).reshape(images.shape)


def _keep_outside_centre(h: int, w: int, e: int, device) -> torch.Tensor:
    """(h, w) mask that zeroes the centred e-box of an fftshifted spectrum."""
    ih, iw = torch.arange(h, device=device), torch.arange(w, device=device)
    mh = (ih >= h // 2 - e) & (ih < h // 2 + e)
    mw = (iw >= w // 2 - e) & (iw < w // 2 + e)
    return ~(mh[:, None] & mw[None, :])


def _keep_inside_border(h: int, w: int, e: int, device) -> torch.Tensor:
    """(h, w) mask that zeroes the e-wide border band of an fftshifted spectrum."""
    ih, iw = torch.arange(h, device=device), torch.arange(w, device=device)
    mh = (ih < e) | (ih >= h - e)
    mw = (iw < e) | (iw >= w - e)
    return ~(mh[:, None] | mw[None, :])


def _dft_filter(images: torch.Tensor, magnitude: int, mask_fn) -> torch.Tensor:
    n, h, w, c = images.shape
    e = min(int(magnitude), min(w // 2, h // 2))
    if e <= 0:
        return images
    f = torch.fft.fftshift(torch.fft.fft2(images, dim=(1, 2)), dim=(1, 2))
    f = f * mask_fn(h, w, e, images.device)[None, :, :, None]
    out = torch.fft.ifft2(torch.fft.ifftshift(f, dim=(1, 2)), dim=(1, 2)).real
    return minmax_norm(out)


def high_pass_filter(images: torch.Tensor, magnitude: int) -> torch.Tensor:
    """Zero the fftshifted low-frequency centre box, min-max renormalise."""
    return _dft_filter(images, magnitude, _keep_outside_centre)


def low_pass_filter(images: torch.Tensor, magnitude: int) -> torch.Tensor:
    """Zero the fftshifted high-frequency border band, min-max renormalise."""
    return _dft_filter(images, magnitude, _keep_inside_border)


def global_contrast_normalization(images: torch.Tensor, scale: str = "l1") -> torch.Tensor:
    """Per sample: subtract the image's mean, divide by its mean absolute
    deviation (l1) or by its L2 norm over the number of features (l2)."""
    assert scale in ("l1", "l2")
    n = images.shape[0]
    flat = images.reshape(n, -1)
    flat = flat - flat.mean(dim=1, keepdim=True)
    if scale == "l1":
        s = flat.abs().mean(dim=1, keepdim=True)
    else:
        s = flat.square().sum(dim=1, keepdim=True).sqrt() / flat.shape[1]
    return (flat / s).reshape(images.shape)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    """Channel-mean grayscale, one channel kept."""
    return images.mean(dim=-1, keepdim=True)


# the JAX package's string ids of the MSM filters
FILTERS = {
    "blur": lambda x, m: gaussian_blur(x, float(m)),
    "sharpen": lambda x, m: unsharp_mask(x, float(m) * 100.0),
    "hpf": lambda x, m: high_pass_filter(x, int(m)),
    "lpf": lambda x, m: low_pass_filter(x, int(m)),
}
