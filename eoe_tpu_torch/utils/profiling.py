"""Profiling helpers: the port of eoe_tpu/utils/profiling.py.

``profile`` records a ``torch.profiler`` trace of the block it wraps and
writes it to ``logdir`` as a Chrome trace (open it in Perfetto or
chrome://tracing); ``device_seconds`` reads from it how long the card was
busy; ``step_timer`` is a wall clock around a step that waits for the card
before it stops.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile(logdir: str, enabled: bool = True):
    """Trace the block on the host and, where a card is present, on the
    card; yields the ``torch.profiler.profile`` object (None when disabled),
    whose ``key_averages()`` and ``events()`` the caller may read. The trace
    is written to ``<logdir>/trace.json``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_seconds(prof) -> float:
    """Seconds in which at least one kernel ran on the card, from a finished
    ``profile``: the union of the device events' intervals (0.0 when the
    trace holds none, as on the CPU)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


@contextlib.contextmanager
def step_timer(results: list):
    """Append the seconds the block took to ``results``. The block may put a
    tensor under ``out["sync"]``: the clock then stops only after the card
    has finished the work queued on that tensor's device."""
    t0 = time.perf_counter()
    out = {}
    yield out
    sync = out.get("sync")
    if isinstance(sync, torch.Tensor) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)
    results.append(time.perf_counter() - t0)
