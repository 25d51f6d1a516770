"""The benchmark's weights: drawn on the device from the run seed in one
call, float32, under the names and shapes of a family reference's
``param_specs``. Both the program and the reference take them."""

import math
from typing import Dict

import torch

from portbench.harness.common import seed_of

WEIGHTS = 5   # purpose of the run seed


def make(specs: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    drawn = [n for n, (_s, how) in specs.items() if how[0] in ("normal", "ones")]
    total = sum(math.prod(specs[n][0]) for n in drawn)
    g = torch.Generator(device=device).manual_seed(seed_of(seed, WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, how) in specs.items():
        if how[0] == "const":
            out[name] = torch.full(shape, float(how[1]), device=device)
            continue
        k = math.prod(shape)
        t = flat[at:at + k].view(shape) * how[1]
        out[name] = t + 1.0 if how[0] == "ones" else t
        at += k
    return out
