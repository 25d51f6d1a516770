"""The kind ``closed_loop``: one client calling ``AnomalyScorer.score`` back
to back, a request being ``n`` raw images from a pool made from the seed.

The mix's parameters: ``class`` (the prompt centre's class), ``raw_size``,
``channels``, ``pool`` (images in the pool) and its ``content``, and
``sizes``: ``count`` points spread evenly in probability over a
``log_uniform`` [lo, hi] distribution, the same for every seed; the seed
orders them (a fresh order each pass through them) and picks where in the
pool each request's images start.

Set-up: the process, the program's imports and kernel builds, the weights
made from the seed, the model, the prompt centre and the scorer, the image
pool, and one request of each number of batches the mix's sizes need (the
shapes the window uses). The window holds whole passes over the mix's
sizes, so that every seed serves the same work: requests are sent until a
pass ends after ``--seconds`` has passed since the first, and the window
ends when the last returns. A request's latency runs from the call to
``score`` to its returned array.
"""

import gc
import math
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from portbench.harness import check, trace as tracing
from portbench.harness import traffic as gen
from portbench.harness.common import family_module, seed_of

ROLE = "serve"   # what the per-layer metrics read it as


def request_sizes(t: dict) -> np.ndarray:
    """The ``count`` sizes of a closed loop, evenly spread in probability."""
    s = t["sizes"]
    lo, hi = s["log_uniform"]
    q = (np.arange(s["count"]) + 0.5) / s["count"]
    return np.clip(np.round(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))),
                   lo, hi).astype(np.int64)


def pool(t: dict, seed: int, device) -> np.ndarray:
    return gen.images(t["pool"], t["raw_size"], t["channels"], t["content"],
                      gen.generator(seed, gen.IMAGES, device), device)


def requests(t: dict, seed: int) -> Iterator[Tuple[int, int]]:
    """(offset into the pool, size) of each request, without end."""
    sizes = request_sizes(t)
    order = np.random.default_rng(seed_of(seed, gen.ORDER))
    offsets = np.random.default_rng(seed_of(seed, gen.OFFSETS))
    while True:
        for n in sizes[order.permutation(len(sizes))]:
            yield int(offsets.integers(0, t["pool"] - n + 1)), int(n)


def end_to_end(out: dict, t0: float) -> dict:
    """The end-to-end metrics a run of this kind gives, by name."""
    return {"setup_s": out["setup_end"] - t0,
            "serve_img_per_s": out["images"] / out["window_s"],
            "serve_p95_ms": float(np.percentile(out["latencies"], 95)) * 1e3}


def attempted(out: dict) -> int:
    return out["requests"]


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, chips: int = 1, keep: Optional[dict] = None) -> dict:
    """One run; ``keep``, where given, receives what the check compared
    (``pool``, ``served``, ``readings``), for the control's tests."""
    from portbench.harness import weights as wgen

    fam = family_module(cfg["family"])
    sv = cfg["serve"]
    weights = wgen.make(fam.reference.param_specs(cfg), seed, device)
    scorer = fam.build_scorer(cfg, weights, sv["dataset"], traffic["class"], device)
    del weights
    images = pool(traffic, seed, device)
    batch = sv["batch_size"]
    per_pass = len(request_sizes(traffic))
    for k in sorted({-(-int(n) // batch) for n in request_sizes(traffic)}):
        scorer.score(images[:k * batch])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_end = time.perf_counter()
    served, latencies = [], []
    prof = traced = None
    warm, traced_requests = cell.get("trace_after", 0), cell.get("trace_requests", 0)
    start = time.perf_counter()
    for i, (off, n) in enumerate(requests(traffic, seed)):
        if trace and i == warm:
            prof = tracing.start()
            t0, i0 = time.perf_counter(), len(served)
        t = time.perf_counter()
        scores = scorer.score(images[off:off + n])
        latencies.append(time.perf_counter() - t)
        served.append((off, n, scores))
        if trace and i == warm + traced_requests - 1:
            traced = (time.perf_counter() - t0, sum(r[1] for r in served[i0:]),
                      len(served) - i0)
            tracing.stop(prof)
            break
        if not trace and (i + 1) % per_pass == 0 and time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    result = {"window_s": end - start, "images": sum(r[1] for r in served),
              "requests": len(served), "latencies": latencies, "setup_end": setup_end,
              "peak": peak, "slots": sum(-(-r[1] // batch) * batch for r in served)}
    if trace:
        result["trace"] = tracing.read(prof, *traced)
        result["trace"]["slots"] = sum(-(-r[1] // batch) * batch
                                       for r in served[-traced[2]:])
    del scorer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["checks"] = check.serving(cell, cfg, images, served, traffic["class"], seed, device,
                                     keep)
    if keep is not None:
        keep.update(pool=images, served=served)
    return result
