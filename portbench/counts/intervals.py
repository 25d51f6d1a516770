"""The seconds in which at least one kernel ran: the union of the device
events' intervals (``eoe_tpu_torch/utils/profiling.py:35-47``,
``device_seconds``), here over (start, end) pairs in microseconds, so that
overlapping kernels (NCCL, side streams) count once."""

from typing import Iterable, List, Tuple


def union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] (microseconds) between the spans."""
    out, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
