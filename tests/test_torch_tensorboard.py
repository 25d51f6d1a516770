"""The port's ``Logger`` tensorboard writer against the JAX package's: the
same scalars and histograms in ``tb/`` events where tensorboard imports,
and a quiet fall-back to scalars.json where it does not."""

import json
import os
import sys

import numpy as np
import pytest

from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.utils.logger import Logger

pytest.importorskip("tensorboard")
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator  # noqa: E402


def _log(logger):
    rng = np.random.default_rng(0)
    for step in range(3):
        logger.add_scalar("training_cls0_seed0_loss", 1.0 / (step + 1), step)
        logger.hist("Training: CLS0 SEED0 anomaly_scores normal", rng.normal(0, 1, 50), step)
    logger.hist("empty", np.array([np.nan]), 0)   # nothing finite: no record
    logger.flush_scalars()


def _events(run):
    acc = EventAccumulator(os.path.join(run, "tb"), size_guidance={"scalars": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    hists = {t: [(e.step, e.histogram_value.num, e.histogram_value.sum,
                  e.histogram_value.min, e.histogram_value.max) for e in acc.Histograms(t)]
             for t in tags["histograms"]}
    return scalars, hists


def test_writer_matches_jax(tmp_path):
    port = Logger(str(tmp_path / "port"), noname=True, archive_source=False)
    jax_logger = JaxLogger(str(tmp_path / "jax"), noname=True, archive_source=False)
    for logger in (port, jax_logger):
        _log(logger)
    jax_logger.tb_writer.flush()   # the JAX logger's flush_scalars leaves its writer alone
    assert [f.split(".")[:3] for f in os.listdir(tmp_path / "port" / "tb")] == \
        [["events", "out", "tfevents"]]
    scalars, hists = _events(port.dir)
    assert (scalars, hists) == _events(jax_logger.dir)
    assert [s for _, s in scalars["training_cls0_seed0_loss"]] == pytest.approx([1, 0.5, 1 / 3])
    assert [h[:2] for h in hists["Training: CLS0 SEED0 anomaly_scores normal"]] == \
        [(0, 50), (1, 50), (2, 50)]
    with open(tmp_path / "port" / "scalars.json") as f, \
            open(tmp_path / "jax" / "scalars.json") as g:
        assert json.load(f) == json.load(g)
    port.close()
    assert port.tb_writer is None


def test_falls_back_quietly_without_tensorboard(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # import fails
    port = Logger(str(tmp_path / "run"), noname=True, archive_source=False)
    assert port.tb_writer is None
    _log(port)
    port.close()
    assert not os.path.exists(tmp_path / "run" / "tb")
    assert capsys.readouterr().out == "" and not os.path.exists(tmp_path / "run" / "warnings.txt")
    with open(tmp_path / "run" / "scalars.json") as f:
        records = json.load(f)
    assert len(records["training_cls0_seed0_loss"]) == 3
    assert len(records["hist/Training: CLS0 SEED0 anomaly_scores normal"]) == 3
    off = Logger(str(tmp_path / "off"), noname=True, archive_source=False, tensorboard=False)
    assert off.tb_writer is None and not os.path.exists(tmp_path / "off" / "tb")
