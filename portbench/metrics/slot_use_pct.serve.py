"""The share of the rows the scorer computed in the traced serving window
that held a requested image: the ``images`` over the ``slots`` (padding
included) that ``AnomalyScorer.score`` counts on its ``eoe.serve.request``
spans (``eoe_tpu_torch/utils/profiling.py``), which record only while the
window's profiler runs; none: nothing to read."""

from eoe_tpu_torch.utils import profiling


def read(ctx):
    # the traced runs of a program older than its spans read nothing
    done = getattr(profiling, "closed_spans", list)()
    requests = [s for s in done if s.name == "eoe.serve.request"]
    slots = sum(s.counts.get("slots", 0) for s in requests)
    if not slots:
        return None
    return 100.0 * sum(s.counts["images"] for s in requests) / slots
