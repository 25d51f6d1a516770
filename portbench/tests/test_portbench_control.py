"""The controls of ``correct``: the reference put in the program's place,
computed in the nearest precision below the configuration's (the cell's
``control``: fp8 for a bf16 model, TF32 for fp32 with TF32 off), or the
program's own path in that precision where it has one (``program-<dtype>``:
bf16 for the fp32 WideResNet, whose convolutions take TF32), has to fail one
of the cell's numbers, while the program's own runs pass; where the program
derives a centre (CLIP's prompts), the control has to fail them also when
its steps take the float32 reference's centre, so that the steps alone are
caught. With it, the planted faults' readings that need a run: half of the
batch left out, the mean taken over the rest and a state left unchanged,
planted in the reference (training), at the first steps and at the window's.

On the card at the cells' own sizes (``-m cuda``), at tiny sizes on the
CPU. The same readings, for many seeds in one process, where the limits
come from:

    python -m portbench.tests.test_portbench_control <cell> <first seed> <seeds> [controls [seconds]]

(a training cell's window reaches its schedule's first milestone, and the
step the check follows there, only in a window as long as the benchmark's).
"""

import json
import os
import sys
import time

import pytest
import torch

from portbench.harness import check
from portbench.harness.common import BENCH_DIR, ROOT, find, kind_module
from portbench.reference.train import Optimizer

SEEDS = (2 ** 31 + 11, 977, 123456789)


def _run(name, seed, seconds, device, bench_dir, dtype=None):
    """A run of cell ``name``; ``dtype`` runs the program's training in that
    compute dtype instead of the configuration's."""
    cell = find("cells", name, bench_dir)
    cfg = find("configs", cell["config"], bench_dir)
    if dtype is not None:
        cfg["train"]["compute_dtype"] = dtype
    traffic = find("traffic", cell["traffic"], bench_dir)
    keep = {}
    out = kind_module(traffic["kind"], bench_dir).run(cell, cfg, traffic, seed, seconds, False,
                                                      device, cell["chips"], keep)
    keep["run"] = {k: out[k] for k in ("images", "window_s", "epochs", "captures")
                   if k in out}
    return cell, cfg, keep


def half_batch(b: dict) -> dict:
    """The fault: the second half of the batch (the OE half) left out, the
    mean taken over the rest."""
    return {**b, "w_o": torch.zeros_like(b["w"])}


class Frozen(Optimizer):
    """The fault: a step that leaves the state unchanged."""

    def step(self, params, grads):
        self.t += 1


def control_training(cfg, keep, seed, device, precision, fault=None, optimizer=Optimizer,
                     centre="own") -> dict:
    """The numbers of the reference in ``precision`` (with ``fault`` or a
    faulty ``optimizer``) put in the program's place, against the float32
    reference: the first steps' and, from the program's state, the window
    steps'. The control's steps take, with ``centre`` "own", the centre it
    derives in its precision (as the program's steps take the program's),
    with "reference" the float32 reference's."""
    program = keep["program"]
    weights = check.outputs(program["outputs"])[1]
    control = fault is None and optimizer is Optimizer
    if control and centre == "reference":
        ref = check.reference_training(cfg, keep["inputs"], {**program, "centre": None}, seed,
                                       device)
        got = check.reference_training(cfg, keep["inputs"], {**program, "centre": ref["centre"]},
                                       seed, device, precision)
        numbers = check.training_numbers({**got, "weights": weights}, ref)
    else:
        own = {**program, "centre": None} if control else program
        got = check.reference_training(cfg, keep["inputs"], own, seed, device, precision, fault,
                                       optimizer)
        mid = got["centre"] if control else program["centre"]
        ref = check.reference_training(cfg, keep["inputs"], {**program, "centre": mid},
                                       seed, device)
        numbers = check.training_numbers({**got, "centre": mid, "weights": weights}, ref)
    del got, ref
    if optimizer is Optimizer and centre == "own":
        win = check.window_reference(cfg, keep["inputs"], program, seed, device, precision, fault)
        win = [{**g, "weights": check.outputs(w["outputs"])[1]}
               for g, w in zip(win, program["window"])]
        numbers.update(check.window_numbers(win, check.window_reference(
            cfg, keep["inputs"], program, seed, device)))
    return numbers


def control_serving(cell, cfg, keep, seed, device, precision, bench_dir=BENCH_DIR) -> dict:
    served = keep["served"]
    pick = check.sample_requests(served, seed, cell["check_images"])
    reqs = [served[i][:2] for i in pick]
    traffic = find("traffic", cell["traffic"], bench_dir)
    got = check.reference_scores(cfg, keep["pool"], reqs, traffic["class"], seed, device, precision)
    ref = check.reference_scores(cfg, keep["pool"], reqs, traffic["class"], seed, device)
    return {"score_gap": max(float(abs(a - b).max()) for a, b in zip(got, ref))}


def readings(name, seeds, seconds, device, bench_dir=BENCH_DIR, controls=True):
    """Per seed: the program's numbers, and with ``controls`` the control's
    (for a centre that the program derives, also with the float32
    reference's centre) and the planted faults'."""
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        cell, cfg, keep = _run(name, seed, seconds, device, bench_dir)
        row = {"cell": name, "seed": seed, "program": keep["readings"], "run": keep["run"]}
        train = "program" in keep
        if controls and train and cell["control"].startswith("program-"):
            # the program's own lower-precision path is the control
            row["control"] = _run(name, seed, seconds, device, bench_dir,
                                  cell["control"][len("program-"):])[2]["readings"]
        elif controls and train:
            row["control"] = control_training(cfg, keep, seed, device, cell["control"])
            if keep["program"]["centre"] is not None:
                row["control_reference_centre"] = control_training(
                    cfg, keep, seed, device, cell["control"], centre="reference")
        if controls and train:
            row["half_batch"] = control_training(cfg, keep, seed, device, "fp32", half_batch)
            row["unchanged_state"] = control_training(cfg, keep, seed, device, "fp32",
                                                      optimizer=Frozen)
        elif controls:
            row["control"] = control_serving(cell, cfg, keep, seed, device, cell["control"],
                                             bench_dir)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del keep
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


def _assert_separates(rows, limits):
    for r in rows:
        assert not _fails(r["program"], limits), r
        assert _fails(r["control"], limits), r
        for fault in ("control_reference_centre", "half_batch", "unchanged_state"):
            if fault in r:
                assert _fails(r[fault], limits), (fault, r)


@pytest.mark.parametrize("name", ["tiny_clip-train", "tiny_wrn-train", "tiny_clip-serve"])
def test_control_fails_tiny(name, tmp_path, monkeypatch):
    from portbench.tests import tiny
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    bench, _ = tiny.write(tmp_path)
    rows = readings(name, SEEDS[:1], 0.2, "cpu", bench)
    _assert_separates(rows, tiny.CELLS[name]["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["clip_vitb32-train", "wrn_cbam-train", "clip_vitb32-serve",
                                  "clip_vitb32-train-dp4"])
def test_control_fails_card(name):
    chips = find("cells", name)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA card(s)")
    rows = readings(name, SEEDS, 2.0, "cuda")
    _assert_separates(rows, find("cells", name)["limits"])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    name, first, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    readings(name, [first + 7919 * i for i in range(n)],
             float(sys.argv[5]) if len(sys.argv) > 5 else 2.0, "cuda",
             controls=len(sys.argv) > 4 and sys.argv[4] == "1")
