"""The program's spans (``eoe_tpu_torch.utils.profiling.span``) on the CPU:
nothing recorded and no host range entered while no profiler runs; under
``torch.profiler`` the records' nesting, counts and exception exits and
the ranges in the profiler's events; the scorer's request spans and counts
(scores bitwise equal to an untraced call); the trainer's epoch spans on
the resident epoch (``EOE_TPU_CPU_SCAN=1``) and the per-step loop (outputs
bitwise equal to an untraced run, the epoch's rate on the epoch span's
stamp); and the benchmark's three readers of these spans, called on a
``portbench.run.Context`` as the harness calls them, reading nothing where
a span was dropped."""

import types

import numpy as np
import pytest
import torch

from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models import CNN32
from eoe_tpu_torch.training import TRAINER
from eoe_tpu_torch.training import trainer as T
from eoe_tpu_torch.utils import profiling
from portbench.harness import common
from portbench.run import Context

BATCH, N_NORMAL, N_OE = 8, 32, 28     # 4 steps an epoch
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear_spans()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    profiling.clear_spans()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _names(records):
    return [s.name for s in records]


def test_span_without_profiler_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast", lambda name: entered.append(name))

    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=no_clock))
    with profiling.span("eoe.test.outer", n=1) as outer:
        with profiling.span("eoe.test.inner") as inner:
            inner.add(bytes=3)
            inner.stamp(1)
    assert outer is inner is profiling.span("eoe.test.other")
    assert profiling.spans() == [] and profiling.spans_dropped() == 0
    assert entered == []


def test_span_records_nesting_counts_and_exceptions():
    with _profiler() as prof:
        with profiling.span("eoe.test.request", images=3) as req:
            with profiling.span("eoe.test.upload", bytes=10) as up:
                up.add(bytes=5)
            req.add(slots=4)
            with pytest.raises(ValueError):
                with profiling.span("eoe.test.batch"):
                    raise ValueError("left by an exception")
        with profiling.span("eoe.test.next"):
            pass
    req, up, batch, nxt = profiling.spans()
    assert _names([req, up, batch, nxt]) == [
        "eoe.test.request", "eoe.test.upload", "eoe.test.batch", "eoe.test.next"]
    assert req.parent is None and req.root == req.id
    assert up.parent == batch.parent == req.id and up.root == batch.root == req.id
    assert nxt.parent is None and nxt.root == nxt.id != req.id
    assert req.counts == {"images": 3, "slots": 4} and up.counts == {"bytes": 15}
    for s in (req, up, batch, nxt):
        assert s.start_ns <= s.end_ns
    assert req.start_ns <= up.start_ns and up.end_ns <= batch.start_ns
    assert batch.end_ns <= req.end_ns <= nxt.start_ns
    traced = {e.name for e in prof.events()}
    assert {"eoe.test.request", "eoe.test.upload", "eoe.test.batch", "eoe.test.next"} <= traced


def test_span_stamps_and_cap(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _profiler():
        with profiling.span("eoe.test.stamped") as s:
            s.stamp(5)
        for _ in range(4):
            with profiling.span("eoe.test.more"):
                pass
    kept = profiling.spans()
    assert len(kept) == 3 and profiling.spans_dropped() == 2
    assert kept[0].start_ns == 5 < kept[0].end_ns
    assert profiling.closed_spans() == []   # a partial record reads as none
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_closed_spans_leave_out_the_open_ones():
    with _profiler():
        with profiling.span("eoe.test.open"):
            with profiling.span("eoe.test.done"):
                pass
            assert _names(profiling.spans()) == ["eoe.test.open", "eoe.test.done"]
            assert _names(profiling.closed_spans()) == ["eoe.test.done"]
    assert _names(profiling.closed_spans()) == ["eoe.test.open", "eoe.test.done"]


def test_profile_clears_the_spans(tmp_path):
    with _profiler():
        with profiling.span("eoe.test.before"):
            pass
    with profiling.profile(str(tmp_path)):
        with profiling.span("eoe.test.inside"):
            pass
    assert _names(profiling.spans()) == ["eoe.test.inside"]


def _scorer(batch=128):
    torch.manual_seed(0)
    model = CNN32(rep_dim=16)
    return AnomalyScorer(model.state_dict(), CNN32(rep_dim=16), test_specs=[],
                         batch_size=batch, device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def test_scorer_request_spans_and_bitwise_scores():
    scorer, x = _scorer(), _images(130)
    plain = scorer.score(x)
    assert profiling.spans() == []
    with _profiler():
        traced = scorer.score(x)
    np.testing.assert_array_equal(traced, plain)
    records = profiling.spans()
    assert _names(records) == ["eoe.serve.request", "eoe.serve.upload", "eoe.serve.batch",
                               "eoe.serve.pad", "eoe.serve.upload", "eoe.serve.batch",
                               "eoe.serve.download"]
    req = records[0]
    assert req.counts == {"images": 130, "slots": 256, "batches": 2,
                          "upload_bytes": 256 * 32 * 32 * 3}
    assert all(s.root == req.id and s.parent == req.id for s in records[1:])
    assert [s.counts["bytes"] for s in records if s.name == "eoe.serve.upload"] == [
        128 * 32 * 32 * 3] * 2


def _dataset():
    rng = np.random.default_rng(0)
    x, xo = (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8) for n in (N_NORMAL, N_OE))
    kw = dict(root="", train_specs=["normalize"], test_specs=["normalize"], n_classes=2,
              raw_shape=(32, 32, 3), ds_statistics=STATS)
    normal = B.GenericADDataset(B.ArraySource(x, np.zeros(N_NORMAL)), None,
                                normal_classes=(0,), nominal_label=0, **kw)
    oe = B.GenericADDataset(B.ArraySource(xo, np.ones(N_OE)), None,
                            normal_classes=(1,), nominal_label=1, **kw)
    return B.CombinedDataset(normal, oe)


def _train(monkeypatch, resident: bool, traced: bool, epochs: int = 2):
    if resident:
        monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    else:
        monkeypatch.delenv("EOE_TPU_CPU_SCAN", raising=False)
    monkeypatch.delenv("EOE_TPU_CHUNK", raising=False)
    torch.manual_seed(0)
    tr = TRAINER["hsc"](model=CNN32(rep_dim=16), train_specs=["normalize"],
                        test_specs=["normalize"], logger=None, epochs=epochs, lr=1e-3,
                        device="cpu", dataset="cifar10", oe_dataset="cifar100", datapath="",
                        wdk=1e-3, milestones=[1], batch_size=BATCH)
    ds = _dataset()
    assert tr.resident_epoch(ds) == resident
    if traced:
        with _profiler():
            state, _ = tr.train_cls(ds, 0, "airplane", 0, seed=11)
    else:
        state, _ = tr.train_cls(ds, 0, "airplane", 0, seed=11)
    return tr, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "per_step"])
def test_trainer_epoch_spans(monkeypatch, resident):
    plain, plain_params = _train(monkeypatch, resident, traced=False)
    assert profiling.spans() == []
    tr, params = _train(monkeypatch, resident, traced=True)
    assert tr.step_losses == plain.step_losses
    for k, v in plain_params.items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    records = profiling.spans()
    inner = ["eoe.train.plan_load"] + ["eoe.train.chunk"] * 4 if resident else []
    per_epoch = ["eoe.train.epoch"] + inner + ["eoe.train.download", "eoe.train.log"]
    assert _names(records) == per_epoch * 2
    epochs = [s for s in records if s.name == "eoe.train.epoch"]
    for k, epoch in enumerate(epochs):
        assert epoch.counts == {"epoch": k, "steps": 4, "images": 2 * BATCH * 4}
        children = records[records.index(epoch) + 1:][:len(per_epoch) - 1]
        assert all(c.parent == epoch.id == c.root for c in children)
        # the rate's clock starts at the epoch span's stamp and stops in its log
        log = children[-1]
        dt_ns = 2 * BATCH * 4 / tr.epoch_rates[k] * 1e9
        assert log.start_ns - epoch.start_ns <= dt_ns * (1 + 1e-9)
        assert dt_ns <= (log.end_ns - epoch.start_ns) * (1 + 1e-9)


def test_epoch_rate_reads_no_wall_clock(monkeypatch):
    clock = types.SimpleNamespace(perf_counter_ns=T.time.perf_counter_ns)
    monkeypatch.setattr(T, "time", clock)   # time.time would raise AttributeError
    tr, _ = _train(monkeypatch, resident=True, traced=False)
    assert len(tr.epoch_rates) == 2 and all(r > 0 for r in tr.epoch_rates)
    assert tr.train_seconds > 0


def _read(metric, kind):
    return common.metric_reader(metric)(Context(kind, {}, {}, {}, 1, {}))


def test_serving_readers_on_the_scorers_spans():
    scorer, batch = _scorer(batch=16), 16
    sizes = [130 // 8, 5, 16, 33]
    with _profiler():
        for n in sizes:
            scorer.score(_images(n, n))
    requests = [s for s in profiling.spans() if s.name == "eoe.serve.request"]
    assert [s.counts["images"] for s in requests] == sizes
    # the serving kind's formula for today's padding (portbench/kinds/closed_loop.py)
    slots = sum(-(-n // batch) * batch for n in sizes)
    assert _read("slot_use_pct.serve", "serve") == pytest.approx(100.0 * sum(sizes) / slots,
                                                                 rel=1e-12)
    uploads = [s.end_ns - s.start_ns for s in profiling.spans() if s.name == "eoe.serve.upload"]
    assert len(uploads) == sum(-(-n // batch) for n in sizes)
    assert _read("upload_ms_per_request.serve", "serve") == pytest.approx(
        1e-6 * sum(uploads) / len(sizes), rel=1e-12)
    assert _read("epoch_boundary_ms.train", "train") is None   # no trainer's spans


def test_epoch_boundary_reader(monkeypatch):
    _train(monkeypatch, resident=True, traced=True, epochs=1)
    assert _read("epoch_boundary_ms.train", "train") is None   # one traced epoch
    profiling.clear_spans()
    _train(monkeypatch, resident=True, traced=True, epochs=3)
    records = profiling.spans()
    downloads = [s for s in records if s.name == "eoe.train.download"]
    firsts = [records[records.index(s) + 1] for s in records if s.name == "eoe.train.plan_load"]
    assert len(downloads) == len(firsts) == 3 and all(
        s.name == "eoe.train.chunk" for s in firsts)
    gaps = [b.start_ns - a.end_ns for a, b in zip(downloads, firsts[1:])]
    value = _read("epoch_boundary_ms.train", "train")
    assert value == pytest.approx(1e-6 * sum(gaps) / 2, rel=1e-12) and value > 0
    for metric in ("slot_use_pct.serve", "upload_ms_per_request.serve"):
        assert _read(metric, "serve") is None   # no scorer's spans


@pytest.mark.parametrize("metric,kind", [("epoch_boundary_ms.train", "train"),
                                         ("slot_use_pct.serve", "serve"),
                                         ("upload_ms_per_request.serve", "serve")])
def test_readers_without_spans(monkeypatch, metric, kind):
    """Nothing traced, or a program without the recorder: nothing to read."""
    assert _read(metric, kind) is None
    monkeypatch.delattr(profiling, "closed_spans")
    assert _read(metric, kind) is None


@pytest.mark.parametrize("metric,kind", [("epoch_boundary_ms.train", "train"),
                                         ("slot_use_pct.serve", "serve"),
                                         ("upload_ms_per_request.serve", "serve")])
def test_readers_after_dropped_spans(monkeypatch, metric, kind):
    """A window whose spans were not all kept: nothing to read."""
    _train(monkeypatch, resident=True, traced=True, epochs=3)
    with _profiler():
        _scorer(batch=16).score(_images(40))
    assert _read(metric, kind) is not None
    profiling._RECORDS.dropped = 1
    assert _read(metric, kind) is None
