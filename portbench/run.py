"""The benchmark of eoe_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell ``portbench/cells/<cell>.json`` names its configuration
(``configs/``), its traffic mix (``traffic/``, whose ``kind`` names the
module in ``kinds/`` that makes it and drives the window) and the cards it
needs; the
metrics it reports are the entries of ``BENCHMARK.json`` that list it, each
per-layer metric read by ``metrics/<name>.py``. With ``--trace 0`` the last
line of standard output holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced sub-window. Either way the
run then checks the outputs of its timed path against the plain reference
and prints each number compared beside its limit, last, on standard error
and under ``checks`` in the result line. A run that cannot measure (no
card, too few cards, JAX loaded, any error) exits with another code than 0
and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402


class Context:
    """What a per-layer metric reads: the cell, its configuration and
    traffic, the kind's role (``train`` or ``serve``), the cards, and the
    traced window (``trace``:
    kernels as (start_us, end_us, name), ``busy_s``, ``window_s``,
    ``images``, ``steps``, and for serving ``slots``)."""

    def __init__(self, kind: str, cell: dict, config: dict, traffic: dict, chips: int,
                 trace: dict):
        self.kind, self.cell, self.config, self.traffic = kind, cell, config, traffic
        self.chips, self.trace = chips, trace

    def kernels(self, *parts: str):
        return [(a, b, n) for a, b, n in self.trace["kernels"] if any(p in n for p in parts)]

    @staticmethod
    def seconds(kernels) -> float:
        return sum(b - a for a, b, _ in kernels) * 1e-6


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             bench_dir: Path = common.BENCH_DIR,
             bench_file: Path = common.ROOT / "BENCHMARK.json") -> dict:
    """One run of cell ``name`` on ``device``; returns the result line's
    object. Raises ``BenchError`` where the run cannot measure."""
    from portbench.harness import check

    cell = common.find("cells", name, bench_dir)
    cfg = common.find("configs", cell["config"], bench_dir)
    traffic = common.find("traffic", cell["traffic"], bench_dir)
    e2e, layer = common.benchmark_entries(name, bench_file)
    kind = common.kind_module(traffic["kind"], bench_dir)
    out = kind.run(cell, cfg, traffic, seed, seconds, trace, device, cell["chips"])
    bad = common.forbidden_modules()
    if bad:
        raise common.BenchError(f"JAX or the JAX package was loaded: {bad[:8]}")
    metrics = {}
    if trace:
        by_class = sorted(out["trace"]["by_class"].items(), key=lambda kv: -kv[1])
        print("device seconds by class: " + ", ".join(f"{k} {v!r}" for k, v in by_class),
              file=sys.stderr)
        ctx = Context(kind.ROLE, cell, cfg, traffic, cell["chips"], out["trace"])
        for m in layer:
            value = common.metric_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = kind.end_to_end(out, t0)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    if str(device).startswith("cuda"):
        dev = common.device_info(cell["chips"], out["peak"],
                                 out["trace"]["busy_s"] if trace else None,
                                 out["trace"]["window_s"] if trace else None)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": check.correct(out["checks"]),
              "attempted": kind.attempted(out), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.setup_environment()
    try:
        import torch
        cell = common.find("cells", args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise common.BenchError(
                f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except Exception:   # noqa: BLE001 - any failure: no result, another exit code
        traceback.print_exc()
        return 1
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
