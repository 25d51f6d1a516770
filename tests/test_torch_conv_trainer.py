"""The conv-model path of the port's ``Trainer`` against the JAX package's, on
the CPU at a tiny size: train steps of CNN32 (HSC, DSVDD with its centre,
BCE with the head) and AE32 (the AE objective, which reads the inputs), and
``Trainer.run`` by name on the synthetic CIFAR data.

The port initialises the weights and ``models.convert.to_flax_numpy`` carries
them, batch statistics included. Both sides take the same raw uint8 batches
(numpy, seeded), the same sampler plans and a deterministic pipeline
(``normalize`` with given statistics), so that the steps see the same inputs.

The held steps update with SGD on both sides. The trainers give conv models
Adam, whose per-element normalisation turns float noise into updates of the
learning rate's size: where a gradient element is within noise of zero (the
biases before a batch-statistics BN are exactly zero in exact arithmetic)
its sign is random, and at lr 1e-4 six of fc1's 1M elements ended 2e-4
apart after 3 steps. Adam itself is held against optax in
tests/test_torch_optim.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.ae import AE32 as JaxAE32
from eoe_tpu.models.cnn import CNN32 as JaxCNN32
from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models import AE32, CNN32
from eoe_tpu_torch.models.convert import to_flax_numpy
from eoe_tpu_torch.training import TRAINER, TrainState
from eoe_tpu_torch.training.optim import make_optimizer
from eoe_tpu_torch.utils.logger import Logger

BATCH, N_NORMAL, N_OE, N_TEST, STEPS = 8, 24, 20, 12, 3
SPECS = ["normalize"]
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=1e-2, wdk=1e-3,
              milestones=[], batch_size=BATCH)
LOSS_TOL = 1e-5    # relative
PARAM_TOL = 1e-5   # parameters and running averages after the steps

# objective -> (port model, JAX model, SGD learning rate). Each rate keeps
# the 3 steps descending: DSVDD's loss (~3e2) grows from step to step at
# 1e-2, and the AE loss sums 3072 squared errors (~5e3); a diverging run
# amplifies the summation-order differences of the two packages.
CASES = {
    "hsc": (lambda: CNN32(), lambda: JaxCNN32(), 1e-2),
    "dsvdd": (lambda: CNN32(), lambda: JaxCNN32(), 1e-3),
    "bce": (lambda: CNN32(clf=True), lambda: JaxCNN32(clf=True), 1e-2),
    "ae": (lambda: AE32(), lambda: JaxAE32(), 1e-7),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))


def _combined(mod):
    x, xo, xt = _data()
    kw = dict(root="", train_specs=SPECS, test_specs=SPECS, n_classes=2, raw_shape=(32, 32, 3),
              ds_statistics=STATS)
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def _plans():
    idx_n, idx_o, w = B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, 7).epoch()
    return [(idx_n[s], idx_o[s], w[s]) for s in range(STEPS)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("objective", list(CASES))
def test_conv_train_steps_match_jax(objective):
    port_model, jax_model, lr = CASES[objective]
    model = port_model()
    init = to_flax_numpy(model.state_dict())
    plans = _plans()
    x, xo, _ = _data()

    port = TRAINER[objective](model=model, train_specs=SPECS, test_specs=SPECS, logger=None,
                              epochs=1, device="cpu", **COMMON)
    ds = _combined(B)
    assert isinstance(port.make_optimizer(list(model.parameters()), 1).optimizer,
                      torch.optim.Adam)
    state = TrainState(model, make_optimizer("sgd", model.parameters(), lr, COMMON["wdk"], [],
                                             N_NORMAL // BATCH))
    center = port.prepare_metric("airplane", ds, state, 0)
    port_out = []
    for i_n, i_o, w in plans:
        loss, scores, *_ = port.train_step(
            state, ds, torch.from_numpy(x[i_n]), torch.zeros(BATCH, dtype=torch.int64),
            torch.from_numpy(xo[i_o]), torch.ones(BATCH, dtype=torch.int64),
            torch.from_numpy(w), None, center)
        port_out.append((loss.item(), scores.numpy()))

    jt = JaxTrainer(model=jax_model(), train_specs=SPECS, test_specs=SPECS,
                    logger=JaxLogger("", active=False), epochs=1, objective=objective, **COMMON)
    jds = _combined(JB)
    variables = jax.tree_util.tree_map(jnp.asarray, init)
    tx = jax_make_optimizer("sgd", lr, COMMON["wdk"], [], N_NORMAL // BATCH)
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jcenter = jt.prepare_metric("airplane", jds, jstate, 0)
    if objective == "dsvdd":
        np.testing.assert_allclose(center.numpy(), np.asarray(jcenter), atol=1e-5, rtol=1e-5)
    else:
        assert center is None and jcenter is None
    step = jax.jit(jt._train_step_core(jds, tx, True))
    for (l, s), (i_n, i_o, w) in zip(port_out, plans):
        jstate, (jl, js, _, _) = step(
            jstate, jnp.asarray(x[i_n]), jnp.zeros(BATCH, jnp.int32), jnp.asarray(xo[i_o]),
            jnp.ones(BATCH, jnp.int32), jnp.asarray(w), jax.random.key(0), jcenter, None)
        assert abs(l - float(jl)) <= LOSS_TOL * abs(float(jl)), (l, float(jl))
        np.testing.assert_allclose(s, np.asarray(js), rtol=LOSS_TOL, atol=1e-6)

    trained = dict(_flat(to_flax_numpy(model.state_dict())))
    want = dict(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    assert trained.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(trained[k], v, atol=PARAM_TOL, err_msg=str(k))
    moved = [k for k, v in dict(_flat(init)).items() if not np.allclose(trained[k], v)]
    assert any(k[0] == "batch_stats" for k in moved) and any(k[0] == "params" for k in moved)


def test_eval_uses_running_averages_and_ae_inputs():
    """eval_step runs the model in eval mode (the running averages, no
    update), and the AE score is the reconstruction error of the model's
    own input."""
    tr = TRAINER["ae"](model=AE32(), train_specs=SPECS, test_specs=SPECS, logger=None,
                       epochs=1, device="cpu", **COMMON)
    ds = _combined(B)
    state = TrainState(tr.model, tr.make_optimizer(list(tr.model.parameters()), 1))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    x = torch.from_numpy(_data()[2][:BATCH])
    scores = tr.eval_step(state, ds, x, torch.zeros(BATCH))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    xin = ds.normal.test_pipeline(x)
    with torch.no_grad():
        want = (tr.model(xin) - xin).square().reshape(BATCH, -1).sum(-1)
    torch.testing.assert_close(scores, want)


# ---------------------------------------------------------------- by name


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return out


def _read(path):
    with open(path) as f:
        return json.load(f)


RUN = dict(train_specs=[{"op": "random_hflip", "p": 0.5}, "normalize"], test_specs=SPECS,
           dataset="cifar10", oe_dataset="cifar100", epochs=1, lr=1e-3, wdk=0.0,
           milestones=[], batch_size=32, oe_limit_classes=4)


def test_run_by_name_writes_the_jax_run_directory(tmp_path, monkeypatch):
    """``Trainer.run`` loads cifar10 + cifar100 by name (synthetic data): the
    same datasets as the JAX trainer's (normal classes, OE classes, split
    indices, statistics), the files the JAX package writes (tensorboard
    events are not ported; the previews' grids have the JAX package's
    sizes), finite AUROC, and a snapshot that
    serves through ``AnomalyScorer`` with ``eval_cls``'s scores."""
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    jt = JaxTrainer(model=JaxCNN32(), objective="hsc", datapath=str(tmp_path / "jdata"),
                    logger=JaxLogger(str(tmp_path / "jax"), noname=True, archive_source=False),
                    **RUN)
    port = TRAINER["hsc"](model=CNN32(), datapath=str(tmp_path / "pdata"), device="cpu",
                          logger=Logger(str(tmp_path / "port"), noname=True,
                                        archive_source=False), **RUN)
    rng = lambda: np.random.default_rng([0, 2, 0])   # noqa: E731  (seed 0, class 2, seed 0)
    ours, theirs = port._build_dataset(2, rng(), None), jt._build_dataset(2, rng(), None)
    assert ours.oe.normal_classes == theirs.oe.normal_classes and len(ours.oe.normal_classes) == 4
    for a, b in ((ours.train_set, theirs.train_set), (ours.test_set, theirs.test_set),
                 (ours.oe.train_set, theirs.oe.train_set)):
        np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(ours.ds_statistics["mean"], theirs.ds_statistics["mean"],
                               rtol=2e-5)

    jt.run(run_classes=[2], run_seeds=1)
    _, res = port.run(run_classes=[2], run_seeds=1)
    assert np.isfinite(res["mean_auc"]) and np.isfinite(port.step_losses).all()
    jax_files = {f.replace(".msgpack", ".pt") for f in _files(tmp_path / "jax")
                 if not f.startswith("tb")}
    assert _files(tmp_path / "port") == jax_files
    for name in (f for f in jax_files if f.endswith(".png")):   # previews: other draws
        with Image.open(tmp_path / "port" / name) as got, \
                Image.open(tmp_path / "jax" / name) as want:
            assert got.size == want.size and got.mode == want.mode
    for name in ("results.json", "setup.json", "eval_cls2_it0_anomaly_scores.json"):
        assert _read(tmp_path / "port" / name).keys() == _read(tmp_path / "jax" / name).keys()
    # both cached the statistics of class 2 under the JAX file's keys
    cache = [_read(tmp_path / d / "cifar10" / "stats_cache.json") for d in ("pdata", "jdata")]
    assert cache[0].keys() == cache[1].keys() == {"ADCIFAR10"}

    scores = _read(tmp_path / "port" / "eval_cls2_it0_anomaly_scores.json")
    snapshot = str(tmp_path / "port" / "snapshots" / "snapshot_cls2_it0.pt")
    served = AnomalyScorer(snapshot, CNN32(), test_specs=SPECS, batch_size=32,
                           device="cpu").score(ours.test_set.gather_all())
    np.testing.assert_allclose(served, [scores[str(i)] for i in range(len(served))], atol=1e-6)


def test_resume_takes_the_snapshot_statistics(tmp_path, monkeypatch):
    """A class-seed resumed from a snapshot normalises with the statistics
    stored in it, not with those of the data (the JAX trainer's
    ``load_ds_statistics``)."""
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    tr = TRAINER["hsc"](model=CNN32(), datapath="", device="cpu", logger=None,
                        **{**RUN, "train_specs": SPECS})
    state = TrainState(tr.model, tr.make_optimizer(list(tr.model.parameters()), 1))
    tr.logger = Logger(str(tmp_path), noname=True, archive_source=False)
    path = tr.snapshot("snapshot_cls0_it0", state, 1, STATS)
    assert tr.load_ds_statistics(path) == STATS
    ds = tr._build_dataset(0, np.random.default_rng(0), path)
    assert ds.ds_statistics == ds.oe.ds_statistics == STATS
    assert tr._build_dataset(0, np.random.default_rng(0), None).ds_statistics != STATS


@pytest.mark.parametrize("objective", ["bce", "focal", "dsvdd", "dsad", "ae"])
def test_every_objective_runs_by_name(tmp_path, monkeypatch, objective):
    """One class, one epoch of each conv objective by name: finite losses and
    a results.json."""
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    model = AE32() if objective == "ae" else CNN32(clf=objective in ("bce", "focal"))
    tr = TRAINER[objective](model=model, datapath="", device="cpu",
                            logger=Logger(str(tmp_path), noname=True, archive_source=False),
                            **{**RUN, "train_specs": SPECS})
    _, res = tr.run(run_classes=[0])
    assert len(tr.step_losses) > 0 and np.isfinite(tr.step_losses).all()
    assert (tmp_path / "results.json").exists() and np.isfinite(res["mean_auc"])
