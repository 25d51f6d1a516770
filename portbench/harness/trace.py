"""The traced sub-window: ``torch.profiler`` on the host and the card,
started and stopped where the card is idle (after an epoch's download, or
between requests), and read into the device's kernel intervals, their
union, the host's events and the breakdown."""

from collections import defaultdict
from typing import List, Optional, Tuple

import torch

from portbench.counts.intervals import gaps, union_seconds
from portbench.counts.kernel_class import kernel_class

TOP = 10


def start():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop(prof):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


def _host_label(cpu: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host event open at ``t``."""
    best: Optional[Tuple[float, str]] = None
    for a, b, name in cpu:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "host (no traced op)"


def read(prof, window_s: float, images: int, steps: int) -> dict:
    """The kernels of the traced window and what the metrics read of them."""
    kernels, cpu = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(span)
        else:
            cpu.append(span)
    spans = [(a, b) for a, b, _ in kernels]
    by_name = defaultdict(float)
    for a, b, name in kernels:
        by_name[name[:160]] += (b - a) * 1e-6
    idle = []
    if spans:
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        longest = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
        idle = [[_host_label(cpu, (a + b) / 2), (b - a) * 1e-6] for a, b in longest]
    by_class = defaultdict(float)
    for name, s in by_name.items():
        by_class[kernel_class(name)] += s
    return {"kernels": kernels, "busy_s": union_seconds(spans), "window_s": window_s,
            "nccl_s": sum(b - a for a, b, n in kernels if "nccl" in n.lower()) * 1e-6,
            "images": images, "steps": steps, "by_class": dict(by_class),
            "breakdown": {"device_ops": sorted(([n, s] for n, s in by_name.items()),
                                               key=lambda x: -x[1])[:TOP],
                          "idle_gaps": idle}}
