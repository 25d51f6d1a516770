"""The logger's background writer, ``Timer``/``Tracker``, ``utils.imshow``,
``LazySource`` and ``ADDataset.preview``, against the JAX package's.

The writer mirrors tests/test_trainer.py's ``test_logger_async_io_contract``:
the same artifacts in both modes, ``drain`` idempotent and submittable
again, a failing write a warning. A snapshot queued behind a busy writer
holds the values of when it was taken.
"""

import os.path as pt
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from eoe_tpu.datasets import bases as JB
from eoe_tpu.utils import imshow as jax_imshow
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.models import CNN32
from eoe_tpu_torch.ops.metrics import roc_curve
from eoe_tpu_torch.training import TRAINER, TrainState
from eoe_tpu_torch.utils import imshow
from eoe_tpu_torch.utils.logger import Logger, Tracker


def _logger(path, **kw):
    return Logger(str(path), noname=True, archive_source=False, tensorboard=False, **kw)


def test_logger_async_io_contract(tmp_path, monkeypatch):
    """Image grids, PDFs and snapshots go to the background writer; ``drain``
    puts them on disk, ``EOE_TPU_SYNC_IO=1`` writes inline, and both modes
    give the same PNG pixels, PDF and snapshot tensors."""
    rng = np.random.RandomState(0)
    roc = roc_curve((rng.rand(64) > 0.5).astype(np.int64), rng.randn(64))
    imgs = rng.randint(0, 255, (8, 16, 16, 3)).astype(np.uint8)
    payload = {"params": {"w": torch.arange(4.0)}, "epoch": 3}
    outs = {}
    for mode, sync in (("async", "0"), ("sync", "1")):
        monkeypatch.setenv("EOE_TPU_SYNC_IO", sync)
        logger = _logger(tmp_path / mode)
        assert logger._io_sync is (sync == "1")
        mean = logger.plot_many([roc, roc], labels=["a", "b"], name="roc")
        assert abs(mean.auc - roc.auc) < 1e-9   # the mean comes back at once
        logger.logimg("preview", imgs, nrow=4)
        path = logger.snapshot("snap", payload)
        logger.drain()
        assert pt.isfile(pt.join(logger.dir, "preview.png")) and pt.isfile(path)
        try:
            import matplotlib  # noqa: F401
            assert pt.getsize(pt.join(logger.dir, "roc.pdf")) > 0
        except ImportError:
            pass
        outs[mode] = (np.asarray(Image.open(pt.join(logger.dir, "preview.png"))),
                      torch.load(path, weights_only=True))
        logger.drain()   # idempotent, and writes may be queued again
        logger.logimg("preview2", imgs, nrow=4)
        logger.drain()
        assert pt.isfile(pt.join(logger.dir, "preview2.png"))
    np.testing.assert_array_equal(outs["async"][0], outs["sync"][0])
    assert torch.equal(outs["async"][1]["params"]["w"], outs["sync"][1]["params"]["w"])
    assert outs["async"][1]["epoch"] == outs["sync"][1]["epoch"] == 3
    # a failing write becomes a warnings.txt line, never an exception
    monkeypatch.setenv("EOE_TPU_SYNC_IO", "0")
    logger = _logger(tmp_path / "bad")
    logger.logimg("bad", np.zeros((2, 2), np.uint8))   # not (n, h, w, c)
    logger.drain()
    with open(pt.join(logger.dir, "warnings.txt")) as f:
        assert "logimg(bad) failed" in f.read()


def test_queued_snapshot_holds_the_values_it_was_taken_with(tmp_path, monkeypatch):
    """A snapshot waiting behind a busy writer writes the parameters and
    optimizer state of the moment it was taken, not those of the steps that
    ran meanwhile (CPU tensors are copied into the payload)."""
    monkeypatch.delenv("EOE_TPU_SYNC_IO", raising=False)
    logger = _logger(tmp_path)
    tr = TRAINER["hsc"](model=CNN32(), train_specs=["normalize"], test_specs=["normalize"],
                        dataset="cifar10", oe_dataset="cifar100", datapath="", logger=logger,
                        epochs=1, lr=1e-2, wdk=0.0, milestones=[], batch_size=4, device="cpu")
    model = tr.model
    state = TrainState(model, tr.make_optimizer(list(model.parameters()), 1))
    model(torch.rand(4, 32, 32, 3)).sum().backward()
    state.optimizer.step()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moment = {k: v["exp_avg"].clone() for k, v in enumerate(
        state.optimizer.optimizer.state.values())}
    gate = threading.Event()
    logger._io_submit(gate.wait, "hold the writer")
    path = tr.snapshot("snapshot_cls0_it0", state, 1, None)
    for _ in range(2):   # further steps while the snapshot waits
        state.optimizer.zero_grad()
        model(torch.rand(4, 32, 32, 3)).sum().backward()
        state.optimizer.step()
    assert not pt.exists(path)
    gate.set()
    logger.drain()
    saved = torch.load(path, weights_only=True)
    for k, v in before.items():
        assert torch.equal(saved["params"][k], v), k
    assert any(not torch.equal(model.state_dict()[k], v) for k, v in before.items())
    for i, v in moment.items():
        assert torch.equal(saved["opt_state"]["optimizer"]["state"][i]["exp_avg"], v)


def test_tracker_smoothing_and_counts(capsys):
    """As tests/test_metrics.py's tracker test, and the same counts, smoothed
    metrics and final line as the JAX package's ``Tracker``."""
    from eoe_tpu.utils.logger import Logger as JL

    def drive(logger):
        val = [2.0]
        with logger.track([2, 2], {"loss": lambda: val[0], "tag": lambda: "x"}, "t") as tr:
            for _ in range(2):
                for _ in range(2):
                    val[0] *= 0.5
                    tr.update([0, 1])
                tr.update([1, 0])
        return tr, capsys.readouterr().out.split("\r")[-1]

    port, port_out = drive(_logger("", active=False))
    jax_tr, jax_out = drive(JL("/tmp/eoe_trk", active=False))
    assert port.counts[0] == 2 and port.n == 4
    assert 0 < port._smoothed["loss"] < 2.0
    assert (port.counts, port.n, port._smoothed) == (jax_tr.counts, jax_tr.n, jax_tr._smoothed)
    assert port_out == jax_out and port_out.startswith("t 2/2 0/2 | loss=")
    assert isinstance(port, Tracker)


def test_timeit_prints_its_seconds(tmp_path):
    logger = _logger(tmp_path)
    with logger.timeit("block"):
        pass
    with open(pt.join(logger.dir, "print.txt")) as f:
        line = f.read().strip()
    assert line.startswith("block took ") and line.endswith("s")


@pytest.mark.parametrize("case", ["rgb_u8", "grey_float", "single", "unnormed", "tensor"])
def test_imshow_to_a_path_matches_jax(tmp_path, case):
    """The grid ``imshow`` writes is the JAX package's, pixel for pixel."""
    rng = np.random.default_rng(0)
    imgs, kw = {
        "rgb_u8": (rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8), dict(nrow=2)),
        "grey_float": (rng.normal(0, 3, (7, 5, 5, 1)).astype(np.float32), dict(nrow=3)),
        "single": (rng.random((9, 9, 3)), {}),
        "unnormed": (rng.normal(0.5, 0.6, (4, 8, 8, 3)), dict(nrow=4, norm=False)),
        "tensor": (rng.random((3, 4, 4, 3)).astype(np.float32), dict(nrow=2)),
    }[case]
    want = jax_imshow(imgs, path=str(tmp_path / "jax.png"), **kw)
    got = imshow(torch.from_numpy(imgs) if case == "tensor" else imgs,
                 path=str(tmp_path / "port.png"), **kw)
    assert got == str(tmp_path / "port.png")
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


def _sources(mod, rng):
    images = rng.integers(0, 256, (30, 6, 6, 3), dtype=np.uint8)
    targets = np.arange(30) % 3
    calls = []

    def gather(idx):
        calls.append(np.asarray(idx).copy())
        return images[idx]

    return mod.LazySource(30, (6, 6, 3), targets, gather), images, targets, calls


def test_lazy_source_matches_jax():
    """A loader-backed source: gathers call the loader every time, never
    resident (its splits stream), the JAX package's behaviour."""
    rng = np.random.default_rng(0)
    src, images, targets, calls = _sources(B, np.random.default_rng(0))
    jsrc, *_ = _sources(JB, rng)
    assert len(src) == len(jsrc) == 30 and src.raw_shape == jsrc.raw_shape == (6, 6, 3)
    assert not src.resident and not src.fits_resident(30)
    assert src.resident == jsrc.resident and src.fits_resident(4) == jsrc.fits_resident(4)
    np.testing.assert_array_equal(src.targets, jsrc.targets)
    idx = np.array([4, 0, 29, 4])
    np.testing.assert_array_equal(src.gather(idx), jsrc.gather(idx))
    np.testing.assert_array_equal(src.gather(idx), images[idx])
    src.gather([1, 2])
    assert [c.tolist() for c in calls] == [[4, 0, 29, 4], [4, 0, 29, 4], [1, 2]]
    sub = B.Subset(src, [3, 7, 11])
    np.testing.assert_array_equal(sub.gather_all(), images[[3, 7, 11]])
    assert src.targets.dtype == np.int64


@pytest.mark.parametrize("train,percls", [(True, 20), (True, 3), (False, 4)])
def test_preview_matches_jax(train, percls):
    """Raw uint8 images of each binary class in class order, cut to the
    smallest class's count, equal to the JAX package's."""
    rng = np.random.default_rng(1)
    x, xt = (rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8) for n in (24, 15))
    t, tt = np.arange(24) % 3, np.arange(15) % 3

    def build(mod):
        return mod.GenericADDataset(mod.ArraySource(x, t), mod.ArraySource(xt, tt), root="",
                                    normal_classes=(1,), nominal_label=0, train_specs=[],
                                    test_specs=[], n_classes=3, raw_shape=(8, 8, 3))

    got, want = build(B).preview(percls, train), build(JB).preview(percls, train)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
