"""The images of every traffic mix, made from the run's seed. A mix is the
data file ``traffic/<mix>.json``; its ``kind`` names the module
``kinds/<kind>.py`` that reads the rest of its parameters and drives its
window, and each kind makes its images here.

Images differ from each other as photographs do: each is a per-channel
``level`` plus ``amplitude`` times a mix of two smooth fields (random
images of ``grid`` sides, resized bilinearly) plus ``noise`` times pixel
noise, every parameter drawn per image from its range. Drawn on the device
in a few large calls and made uint8.
"""

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness.common import seed_of

IMAGES, CLASS, ORDER, OFFSETS = 1, 2, 3, 4   # purposes of the run seed
CHUNK = 512


def _uniform(shape, lo_hi, generator, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def images(n: int, size: int, channels: int, content: dict, generator: torch.Generator,
           device) -> np.ndarray:
    """(n, size, size, channels) uint8 on the host."""
    out = np.empty((n, size, size, channels), dtype=np.uint8)
    for i in range(0, n, CHUNK):
        k = min(CHUNK, n - i)
        fields = []
        for g in content["grid"]:
            low = torch.rand((k, channels, g, g), generator=generator, device=device)
            fields.append(2 * F.interpolate(low, size=(size, size), mode="bilinear",
                                            align_corners=False) - 1)
        mix = torch.rand((k, 1, 1, 1), generator=generator, device=device)
        field = mix * fields[0] + (1 - mix) * fields[1]
        level = _uniform((k, channels, 1, 1), content["level"], generator, device)
        amp = _uniform((k, 1, 1, 1), content["amplitude"], generator, device)
        share = _uniform((k, 1, 1, 1), content["noise"], generator, device)
        noise = 2 * torch.rand((k, channels, size, size), generator=generator, device=device) - 1
        x = level + amp * field + share * noise
        out[i:i + k] = (x * 255).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu()
    return out


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, purpose))
