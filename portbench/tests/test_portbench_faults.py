"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip is skipped (``run_cell``) and the rest of a run
is driven with one fault planted in the program, once for each fault the
cell can have: a step that leaves the state unchanged, half of the batch
left out of the loss (the mean over the rest), the exchange between the
ranks left out (each steps on its own gradient), a served answer altered
where it is produced. On the CPU at tiny sizes; on the card (``-m cuda``) the
cells themselves."""

import os

import pytest
import torch

from portbench.harness.common import ROOT
from portbench.run import run_cell

TRAIN_FAULTS = ("unchanged_state", "half_batch")


def _plant(fault: str, monkeypatch):
    if fault == "unchanged_state":
        for opt in (torch.optim.SGD, torch.optim.Adam):
            monkeypatch.setattr(opt, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        from eoe_tpu_torch.ops.losses import OBJECTIVES
        for obj in OBJECTIVES.values():
            def loss(feats, labels, center, *a, weights=None, _orig=obj.loss, **k):
                w = torch.ones_like(labels, dtype=feats.dtype) if weights is None else weights
                w = w.clone()
                w[len(w) // 2:] = 0
                return _orig(feats, labels, center, *a, weights=w, **k)
            monkeypatch.setattr(obj, "loss", loss)
    elif fault == "altered_answer":
        from eoe_tpu_torch.inference import AnomalyScorer
        orig = AnomalyScorer._score_batch

        def score_batch(self, x):
            s = orig(self, x).clone()
            s[0] = s[0] + 0.05
            return s
        monkeypatch.setattr(AnomalyScorer, "_score_batch", score_batch)
    else:
        raise ValueError(fault)


CASES = [("train", f) for f in TRAIN_FAULTS] + [("serve", "altered_answer")]


@pytest.mark.parametrize("kind,fault", CASES)
def test_fault_is_caught_tiny(kind, fault, tmp_path, monkeypatch):
    from portbench.tests import tiny
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    bench, bench_file = tiny.write(tmp_path)
    names = ["tiny_clip-train", "tiny_wrn-train"] if kind == "train" else ["tiny_clip-serve"]
    for name in names:
        assert run_cell(name, 31, 0.2, False, "cpu", 0.0, bench, bench_file)["correct"]
    _plant(fault, monkeypatch)
    for name in names:
        res = run_cell(name, 31, 0.2, False, "cpu", 0.0, bench, bench_file)
        assert not res["correct"], (name, fault, res["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,fault", CASES)
def test_fault_is_caught_card(kind, fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    names = ["clip_vitb32-train", "wrn_cbam-train"] if kind == "train" else ["clip_vitb32-serve"]
    _plant(fault, monkeypatch)
    for name in names:
        res = run_cell(name, 2 ** 31 + 77, 2.0, False, "cuda", 0.0)
        assert not res["correct"], (name, fault, res["checks"])


EXCHANGE_LEFT_OUT = ("import eoe_tpu_torch.parallel.mesh as m\n"
                     "m.all_reduce_grads = lambda params, mesh: None\n")


def _plant_in_every_rank(tmp_path, monkeypatch):
    """The exchange left out in this process and in the ranks it starts."""
    from eoe_tpu_torch.parallel import mesh
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(EXCHANGE_LEFT_OUT)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site), str(ROOT)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setattr(mesh, "all_reduce_grads", lambda params, m: None)


def test_exchange_left_out_tiny(tmp_path, monkeypatch):
    from portbench.tests import tiny
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    bench, bench_file = tiny.write(tmp_path)
    assert run_cell("tiny_clip-train-dp2", 41, 0.2, False, "cpu", 0.0, bench,
                    bench_file)["correct"]
    _plant_in_every_rank(tmp_path, monkeypatch)
    res = run_cell("tiny_clip-train-dp2", 41, 0.2, False, "cpu", 0.0, bench, bench_file)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_exchange_left_out_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards")
    _plant_in_every_rank(tmp_path, monkeypatch)
    res = run_cell("clip_vitb32-train-dp4", 2 ** 31 + 79, 2.0, False, "cuda", 0.0)
    assert not res["correct"], res["checks"]
