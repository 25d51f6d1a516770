"""What every run shares: where the checkout and the benchmark's files lie,
finding a cell, its configuration, its traffic, the traffic's kind and its
metrics by name, the
cache directories, the seeds of the inputs, the JAX guard and the result
line."""

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eoe_tpu")


class BenchError(RuntimeError):
    """A run that cannot measure: it exits with another code than 0 and
    prints no result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``<bench_dir>/<kind>/<name>.json``: a cell, a configuration or a
    traffic mix, by its name."""
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                         f"({path} is missing)")
    return load_json(path)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(ctx)`` of ``<bench_dir>/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader for metric {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(name: str, bench_dir: Path = BENCH_DIR):
    """``<bench_dir>/kinds/<name>.py``, the kind of a traffic mix: its
    generator, its window (``run``), its end-to-end metrics
    (``end_to_end``), what a run attempted (``attempted``) and the ``ROLE``
    the per-layer metrics read it as."""
    path = bench_dir / "kinds" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no traffic kind named {name!r} ({path} is missing)")
    own = BENCH_DIR / "kinds" / f"{name}.py"
    if own.is_file() and own.read_bytes() == path.read_bytes():
        # the benchmark's own module, by its import name: ranks it spawns find it
        return importlib.import_module(f"portbench.kinds.{name}")
    spec = importlib.util.spec_from_file_location(f"portbench_kind_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_module(name: str):
    return importlib.import_module(f"portbench.families.{name}")


def benchmark_entries(cell: str, bench_file: Path = ROOT / "BENCHMARK.json"):
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    that a cell reports: those that list it under ``workloads``, and those
    without the key whose end-to-end metric (``moves``) the cell reports."""
    bench = load_json(bench_file)
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def setup_environment():
    """Cache directories at fixed paths inside the checkout, so that only a
    checkout's first run builds; few host threads."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def seed_of(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (weights, images, order) of a run seed."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), purpose])
               .generate_state(2, dtype=np.uint32).view(np.uint64)[0] >> 1)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_info(chips: int, peak_bytes: int, busy_s: Optional[float] = None,
                window_s: Optional[float] = None) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        out.update(busy_s=busy_s, window_s=window_s)
    return out


def emit(result: dict):
    """The checks on standard error as the last lines there, then the result
    as the last line of standard output, its ``checks`` key last."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
