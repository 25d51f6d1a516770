"""Host milliseconds a request of the traced serving window is held in the
scorer's uploads: the summed durations of its ``eoe.serve.upload`` spans
over the window's ``eoe.serve.request`` spans (``AnomalyScorer.score``;
``eoe_tpu_torch/utils/profiling.py``), which record only while the window's
profiler runs; none: nothing to read. A chunk's copy to the card is a
blocking copy on the compute stream, so most of this is the wait for the
kernels of the chunk before it, not the copy: a copy that stopped blocking
would move that wait into ``eoe.serve.download`` and out of this metric."""

from eoe_tpu_torch.utils import profiling


def read(ctx):
    # the traced runs of a program older than its spans read nothing
    done = getattr(profiling, "closed_spans", list)()
    requests = sum(s.name == "eoe.serve.request" for s in done)
    uploads = [s.end_ns - s.start_ns for s in done if s.name == "eoe.serve.upload"]
    if not requests or not uploads:
        return None
    return 1e-6 * sum(uploads) / requests
