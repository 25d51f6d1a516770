"""The vectorised fitness of the evolutionary search
(``evolve.vmapped.VmappedEvaluator``) on the CPU at a tiny size: against the
port's sequential ``evaluate_individual`` of each candidate, against the JAX
package's ``VmappedEvaluator`` on the same carried init and plans, and the
GA's ``evaluate`` with a registered ``evaluate_population``.

The trainings update with SGD (see tests/test_torch_vmapped_seeds.py). The
comparison with the sequential runs takes a random pipeline (flip, noise),
whose draws every candidate shares; the JAX comparison the deterministic
``normalize``.
"""

import argparse
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eoe_tpu_torch.evolve as P
import eoe_tpu_torch.main as port_main
from eoe_tpu.datasets import bases as JB
from eoe_tpu.evolve import vmapped as JVE
from eoe_tpu.models.cnn import CNN32 as JaxCNN32
from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
from eoe_tpu_torch.models import CNN32
from eoe_tpu_torch.models.convert import to_flax_numpy
from eoe_tpu_torch.ops.metrics import auroc_torch, roc_curve
from eoe_tpu_torch.training import TRAINER
from eoe_tpu_torch.training import trainer as T
from eoe_tpu_torch.training.optim import make_optimizer
from eoe_tpu_torch.utils.logger import Logger

BATCH, N_NORMAL, N_OE, N_TEST, OESIZE = 8, 24, 20, 12, 3
RANDOM_SPECS = [{"op": "random_hflip"}, {"op": "gaussian_noise", "std": 0.05}, "normalize"]
SPECS = ["normalize"]
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=1e-3, wdk=1e-3,
              milestones=[1], batch_size=BATCH)
ARGS = argparse.Namespace(classes=[0], iterations=2)
# five candidates in chunks of two: two full chunks and a remainder; the
# second and the fifth share their values
INDIVIDUALS = [[0, 5, 9], [3, 3, 17], [19, 2, 11], [7, 14, 1], [3, 3, 17]]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One CPU thread for this module's tests: the stacked steps run many
    small kernels, and with the test workers sharing the cores their
    threads wait on each other (six concurrent copies of one test took
    259 s each with the default threads, 8.5 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _combined(mod, specs):
    rng = np.random.default_rng(0)
    x, xo, xt = (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))
    kw = dict(root="", train_specs=specs, test_specs=SPECS, n_classes=2,
              raw_shape=(32, 32, 3), ds_statistics=STATS)
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    ds = mod.CombinedDataset(normal, oe)
    ds.oe.train_set.valid_indices = np.asarray(ds.oe.train_set.indices).copy()
    return ds


def _port(specs, epochs=2):
    tr = TRAINER["hsc"](model=CNN32(), train_specs=specs, test_specs=SPECS, logger=None,
                        epochs=epochs, device="cpu", **COMMON)
    tr.make_optimizer = lambda params, steps: make_optimizer(
        "sgd", params, COMMON["lr"], COMMON["wdk"], COMMON["milestones"], steps)
    tr.ds = _combined(B, specs)
    return tr


def test_vmapped_fitness_equals_sequential_runs(monkeypatch):
    """Each candidate's fitness equals the mean test AUROC of its own
    sequential ``trainer.run`` (two seeds, each trained one after the
    other)."""
    tr = _port(RANDOM_SPECS)
    fits = VmappedEvaluator(tr, ARGS, chunk=2).evaluate_population(INDIVIDUALS)
    monkeypatch.setattr(tr, "_try_vmap_seeds", lambda *a: None)
    want = [P.evaluate_individual(P.Individual(ind), tr, ARGS, None) for ind in INDIVIDUALS]
    np.testing.assert_allclose(fits, want, atol=TOL)
    assert fits[1] == fits[4] and len(set(np.round(fits, 6))) > 1


def test_vmapped_fitness_in_chunks_that_fit(monkeypatch):
    """Where the card holds fewer candidates than ``chunk``, the evaluator
    trains as many as it holds at a time, with the same fitness."""
    import eoe_tpu_torch.evolve.vmapped as EV
    want = VmappedEvaluator(_port(RANDOM_SPECS, epochs=1), ARGS, chunk=2).evaluate_population(
        INDIVIDUALS[:2])
    asked = []
    monkeypatch.setattr(EV, "members_per_program",
                        lambda tr, key, wanted, probe: asked.append(wanted) or 1)
    fits = VmappedEvaluator(_port(RANDOM_SPECS, epochs=1), ARGS, chunk=2).evaluate_population(
        INDIVIDUALS[:2])
    np.testing.assert_allclose(fits, want, atol=TOL)
    assert asked == [2] * ARGS.iterations


def test_vmapped_fitness_matches_jax():
    """The port's evaluator against the JAX package's on each iteration's
    init (carried with ``to_flax_numpy``) and sampler plans, with the
    deterministic pipeline."""
    tr = _port(SPECS)
    fits = VmappedEvaluator(tr, ARGS, chunk=2).evaluate_population(INDIVIDUALS)
    steps = N_NORMAL // BATCH
    inits, plans = [], []
    for it in range(ARGS.iterations):
        seed = T._seed(0, 0, it, 0)
        tr.init_weights(seed)
        inits.append(to_flax_numpy(tr.model.state_dict()))
        sampler = B.BalancedEpochSampler(N_NORMAL, OESIZE, BATCH, T._seed(seed, 1))
        plans.append([sampler.epoch() for _ in range(2)])

    jt = JaxTrainer(model=JaxCNN32(), train_specs=SPECS, test_specs=SPECS, objective="hsc",
                    logger=JaxLogger("", active=False), epochs=2, **COMMON)
    jt.make_optimizer = lambda s: jax_make_optimizer("sgd", COMMON["lr"], COMMON["wdk"],
                                                     COMMON["milestones"], s)
    init_calls = iter(range(ARGS.iterations))

    def init_state(key, ds, s):
        v = jax.tree_util.tree_map(jnp.asarray, inits[next(init_calls)])
        return JaxState(params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=jt.make_optimizer(s).init(v["params"]),
                        step=jnp.zeros((), jnp.int32))

    made = iter(range(ARGS.iterations))

    class Sampler(JB.BalancedEpochSampler):   # iteration it replays the port's plans
        def __init__(self, *a):
            super().__init__(*a)
            self._plans = iter(plans[next(made)])

        def epoch(self):
            return next(self._plans)

    jt.init_state = init_state
    jt.ds = _combined(JB, SPECS)
    orig = JVE.BalancedEpochSampler
    JVE.BalancedEpochSampler = Sampler
    try:
        jfits = JVE.VmappedEvaluator(jt, ARGS, chunk=2).evaluate_population(INDIVIDUALS)
    finally:
        JVE.BalancedEpochSampler = orig
    assert steps == 3
    np.testing.assert_allclose(fits, jfits, atol=TOL)


def test_batched_auroc_equals_each_row():
    """``torch.func.vmap`` of ``auroc_torch`` over candidates' scores equals
    the per-row AUROC and the trapezoidal ROC AUC, ties included."""
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, 2, 50))
    scores = torch.from_numpy(np.round(rng.normal(size=(4, 50)), 1)).float()
    batched = torch.func.vmap(auroc_torch, in_dims=(None, 0))(labels, scores)
    for k in range(4):
        assert float(batched[k]) == float(auroc_torch(labels, scores[k]))
        assert abs(float(batched[k]) - roc_curve(labels.numpy(), scores[k].numpy()).auc) < 1e-6


def _pool():
    """Image k: zero but for its own 300 values at level 150 + 2.5k, so the
    distances that compete in a pick lie >= 1e-3 apart."""
    flat = np.zeros((40, 64 * 64 * 3), np.uint8)
    for k in range(40):
        flat[k, k * 300:(k + 1) * 300] = int(150 + 2.5 * k)
    return B.Subset(B.ArraySource(flat.reshape(40, 64, 64, 3), np.zeros(40)), np.arange(40))


def _fitness(ind) -> float:
    return ((sum((i + 1) * v for i, v in enumerate(ind)) * 7919) % 1009) / 1009.0


def _run_ga(tmp, vectorised: bool):
    logger = Logger(str(tmp), noname=True, archive_source=False)
    oeds = _pool()
    trainer = SimpleNamespace(oe_dsstr="tinyimages", device=torch.device("cpu"))
    pop, _, toolbox, history, tree = port_main.evolve_setup(
        1, 8, 12, 1.0, 3, 0.5, 0.5, 3, 3, trainer, oeds, argparse.Namespace(), True, seed=11)
    calls = []
    if vectorised:
        toolbox.register("evaluate", None)   # must not be called
        toolbox.register("evaluate_population",
                         lambda inds: calls.append(inds) or [_fitness(i) for i in inds])
    else:
        toolbox.register("evaluate", _fitness)
    P.evaluate(pop, pop, 0, toolbox, history, tree, oeds, logger)
    for gen in range(1, 3):
        P.evolve(pop, gen, toolbox, 0.5, 0.5, history, tree, oeds, logger, seed=11)
    logger.drain()
    return history, calls


def test_ga_evaluates_a_generation_in_one_call(tmp_path):
    """With ``evaluate_population`` registered, ``evaluate`` hands each
    generation's offspring without a fitness to it in one call, and the GA
    makes the decisions of the per-individual evaluation."""
    want, _ = _run_ga(tmp_path / "seq", False)
    got, calls = _run_ga(tmp_path / "vec", True)
    assert got["pop"] == want["pop"] and got["fit"] == want["fit"]
    assert len(calls) == 3 and len(calls[0]) == 8
    assert all(0 < len(c) <= 8 for c in calls[1:])
