"""Milliseconds an epoch boundary of the traced training window leaves the
card with nothing queued: from the end of an epoch's ``eoe.train.download``
(its outputs on the host, the card drained) to the start of the next
epoch's first ``eoe.train.chunk`` (its first replay being launched), the
mean over the boundaries with both ends in the window. The stretch ends at
the replay's start, not its end: a replay returns only once the card has
room for it (on an H100, WRN+CBAM's first replay of an epoch held the host
7-12 ms, while the card started on it within a fraction of a
millisecond). Read from the trainer's spans
(``eoe_tpu_torch/utils/profiling.py``), which record only while the
window's profiler runs; none, or fewer than two traced epochs: nothing to
read."""

from eoe_tpu_torch.utils import profiling


def read(ctx):
    # the traced runs of a program older than its spans read nothing
    done = getattr(profiling, "closed_spans", list)()
    downloads = sorted(s.end_ns for s in done if s.name == "eoe.train.download")
    chunks = sorted(s.start_ns for s in done if s.name == "eoe.train.chunk")
    stretches = []
    for end in downloads:
        first = next((a for a in chunks if a >= end), None)
        if first is not None:
            stretches.append(first - end)
    if not stretches:
        return None
    return 1e-6 * sum(stretches) / len(stretches)
