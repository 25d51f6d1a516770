"""Profiling helpers: the port of eoe_tpu/utils/profiling.py.

``profile`` records a ``torch.profiler`` trace of the block it wraps and
writes it to ``logdir`` as a Chrome trace (open it in Perfetto or
chrome://tracing); ``device_seconds`` reads from it how long the card was
busy; ``step_timer`` is a wall clock around a step that waits for the card
before it stops.

``span(name, **counts)`` marks a block at a layer boundary of the program
(the trainer's epochs, plan loads, chunks, downloads and logs; the scorer's
requests, padding, uploads, batches and download). While no profiler runs
it is one flag check and returns a shared context that does nothing. While
one runs (``profile``, or any ``torch.profiler.profile``), the block enters
a host range of that name in the profiler's timeline, on the clock of its
device trace, so that an exported trace and a reading of idle gaps name
the block; and a ``Span`` record is kept in memory: the name, the
``perf_counter_ns`` stamps, the enclosing open span of the thread
(``parent``), the outermost one (``root``, which every span of one request
or one epoch shares) and the counts, to which the block may add. A block
left by an exception is recorded with its end. ``spans()`` returns the
records in the order the spans started, ``closed_spans()`` those that have
ended, or none where any were dropped (what a reader of the spans takes),
``clear_spans()`` empties them and ``profile`` does so at its start; at
most ``MAX_SPANS`` are kept, and ``spans_dropped()`` counts the rest. Spans sit at layer boundaries only,
never inside a captured step.

The host range is the profiler's plain function range, not
``torch.profiler.record_function``'s user annotation: with the card traced,
the profiler mirrors a user annotation on the card as a device event that
spans the block's kernels and the host gaps between them, which a reading
of the card's kernels would count as busy time.
"""

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

MAX_SPANS = 1 << 20   # records kept between two clears


class Span:
    """One span's record, and the context manager that makes it."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "root", "counts", "_range")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts
        self.id = next(_IDS)
        self.start_ns = self.end_ns = self.parent = self.root = None

    def __enter__(self):
        stack = _open()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        _RECORDS.keep(self)
        return self

    def __exit__(self, *exc):
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()
        _open().pop()
        self._range.__exit__(*exc)
        self._range = None
        return False

    def add(self, **counts: int):
        """Add to the span's counts."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def stamp(self, start_ns: int):
        """Take the caller's ``perf_counter_ns`` reading as the span's start,
        where the caller times the same block for its own use."""
        self.start_ns = start_ns


class _Off:
    """The span of a block that no profiler watches: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts: int):
        pass

    def stamp(self, start_ns: int):
        pass


class _Records:
    def __init__(self):
        self.kept: List[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def keep(self, s: Span):
        with self._lock:
            if len(self.kept) < MAX_SPANS:
                self.kept.append(s)
            else:
                self.dropped += 1

    def clear(self):
        with self._lock:
            self.kept, self.dropped = [], 0


_OFF = _Off()
_IDS = itertools.count()
_RECORDS = _Records()
_THREAD = threading.local()   # .open: the thread's open spans, innermost last


def _open() -> List[Span]:
    stack = getattr(_THREAD, "open", None)
    if stack is None:
        stack = _THREAD.open = []
    return stack


def span(name: str, **counts: int):
    """A context manager marking a block named ``name`` (``eoe.<layer>.<what>``)
    with integer ``counts``; it yields the ``Span``, or a shared context
    that does nothing while no profiler runs."""
    if not _profiler_enabled():
        return _OFF
    return Span(name, counts)


def spans() -> List[Span]:
    """The spans recorded since the last clear, in the order they started."""
    return list(_RECORDS.kept)


def closed_spans() -> List[Span]:
    """The spans recorded since the last clear that have ended, in the order
    they started; none where any were dropped, so that a reading of them
    covers all that was traced or nothing."""
    if _RECORDS.dropped:
        return []
    return [s for s in _RECORDS.kept if s.end_ns is not None]


def clear_spans():
    _RECORDS.clear()


def spans_dropped() -> int:
    """Spans not kept since the last clear: ``MAX_SPANS`` were kept."""
    return _RECORDS.dropped


@contextlib.contextmanager
def profile(logdir: str, enabled: bool = True):
    """Trace the block on the host and, where a card is present, on the
    card, with the program's spans (cleared at the start); yields the
    ``torch.profiler.profile`` object (None when disabled), whose
    ``key_averages()`` and ``events()`` the caller may read. The trace
    is written to ``<logdir>/trace.json``."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear_spans()
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
