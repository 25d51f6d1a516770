"""The resident epoch (``training.graphs``) on the CPU at a tiny size, forced
with ``EOE_TPU_CPU_SCAN=1``: the same step runs uncaptured over the device
plans, the step counter and the output buffers that the card captures. It
is held against the port's per-step epoch for the three engines (the
sequential trainer, the stacked seeds, an ``--ev-vmap`` chunk) with the
JAX package's tolerance for its own scan path (tests/test_trainer.py:
rtol 1e-5, atol 1e-6), and against the JAX package's per-step train steps
(which its own test holds equal to its scan path) on carried-across
weights. Also: ``EOE_TPU_CHUNK``, the per-epoch plan upload, the path
choice, and the trainer's throughput and epoch helpers.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.cnn import CNN32 as JaxCNN32
from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
from eoe_tpu_torch.models import CNN32
from eoe_tpu_torch.models.convert import to_flax_numpy
from eoe_tpu_torch.parallel.mesh import Mesh
from eoe_tpu_torch.training import TRAINER, graphs
from eoe_tpu_torch.training import trainer as T
from eoe_tpu_torch.training import vmapped_seeds as V
from eoe_tpu_torch.training.optim import make_optimizer
from eoe_tpu_torch.utils.logger import Logger

BATCH, N_NORMAL, N_OE, N_TEST = 8, 32, 28, 12     # 4 steps an epoch
RTOL, ATOL = 1e-5, 1e-6
# the CIFAR-10 stack of the JAX package's benchmark (bench.py:91-103): every
# random op of it, drawn from the class-seed's generator
CIFAR_SPECS = [
    {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
     "hue": 0.01},
    {"op": "random_hflip", "p": 0.5},
    {"op": "random_crop", "size": 32, "padding": 4},
    {"op": "gaussian_noise", "std": 0.001},
    "normalize"]
# tie-free random ops for the stacked engines (tests/test_torch_vmapped_seeds.py)
RANDOM_SPECS = [{"op": "random_hflip"}, {"op": "gaussian_noise", "std": 0.05}, "normalize"]
SPECS = ["normalize"]
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", wdk=1e-3,
              milestones=[1], batch_size=BATCH)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One CPU thread: many small kernels (tests/test_torch_vmapped_seeds.py)."""
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


def _trainer(specs, lr=1e-3, sgd=False, epochs=2, logger=None):
    tr = TRAINER["hsc"](model=CNN32(), train_specs=specs, test_specs=SPECS, logger=logger,
                        epochs=epochs, lr=lr, device="cpu", **COMMON)
    if sgd:
        tr.make_optimizer = lambda params, steps: make_optimizer(
            "sgd", params, lr, COMMON["wdk"], COMMON["milestones"], steps)
    tr.ds = _combined(B, specs)
    return tr


def _force(monkeypatch, resident: bool, chunk=None):
    if resident:
        monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    else:
        monkeypatch.delenv("EOE_TPU_CPU_SCAN", raising=False)
    if chunk is None:
        monkeypatch.delenv("EOE_TPU_CHUNK", raising=False)
    else:
        monkeypatch.setenv("EOE_TPU_CHUNK", str(chunk))


def _runners(monkeypatch) -> list:
    """Every ``ResidentSteps`` built from here on, recorded."""
    made = []

    class Recorded(graphs.ResidentSteps):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(graphs, "ResidentSteps", Recorded)
    return made


def _train(monkeypatch, resident: bool, chunk=None, specs=CIFAR_SPECS):
    _force(monkeypatch, resident, chunk)
    tr = _trainer(specs)
    state, roc = tr.train_cls(tr.ds, 0, "airplane", 0, seed=11)
    return (np.array(tr.step_losses), {k: v.clone() for k, v in state.model.state_dict().items()},
            roc.auc, tr)


def _assert_state(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("chunk,steps_per_graph", [(None, 1), (2, 2), (3, 4)])
def test_resident_epoch_equals_per_step(monkeypatch, chunk, steps_per_graph):
    """CNN32 HSC on the CIFAR-10 stack (jitter, flip, padded crop, noise,
    every draw from the class-seed's generator), 2 epochs of 4 steps with a
    milestone between them: every step's loss, the final parameters and BN
    averages and the train AUROC of the resident epoch equal the per-step
    epoch's. Without ``EOE_TPU_CHUNK`` a graph holds one step; 2 divides the
    epoch and is taken; 3 does not, and the whole epoch is
    (eoe_tpu/training/trainer.py:801-804)."""
    losses, params, auc, tr = _train(monkeypatch, False)
    assert not tr.resident_epoch(tr.ds) and len(losses) == 8
    made = _runners(monkeypatch)
    r_losses, r_params, r_auc, r_tr = _train(monkeypatch, True, chunk)
    assert r_tr.resident_epoch(r_tr.ds)
    assert [r.chunk for r in made] == [steps_per_graph]
    np.testing.assert_allclose(r_losses, losses, rtol=RTOL, atol=ATOL)
    _assert_state(params, r_params)
    assert abs(r_auc - auc) <= RTOL


def test_per_epoch_plan_upload_equals_whole(monkeypatch):
    """Above ``PLAN_BYTES`` the plans go to the device one epoch at a time
    into the same buffer (JAX :854-856): the same training."""
    losses, params, _, _ = _train(monkeypatch, True)
    loads = []
    real = graphs.DevicePlans.load
    monkeypatch.setattr(graphs, "PLAN_BYTES", 0)
    monkeypatch.setattr(graphs.DevicePlans, "load", lambda self, e: (
        loads.append((e, self._per_epoch is not None)), real(self, e)))
    r_losses, r_params, _, _ = _train(monkeypatch, True)
    assert loads == [(0, True), (1, True)]
    np.testing.assert_allclose(r_losses, losses, rtol=RTOL, atol=ATOL)
    _assert_state(params, r_params)


@pytest.mark.parametrize("env,steps,default,want", [
    (None, 4, 0, 4), ("2", 4, 0, 2), ("3", 4, 0, 4), ("1", 5, 0, 1), ("8", 4, 0, 4),
    ("0", 6, 0, 6), (None, 4, 1, 1), ("3", 4, 1, 4), ("4", 4, 1, 4)])
def test_chunk_steps(monkeypatch, env, steps, default, want):
    """``EOE_TPU_CHUNK`` where it divides the epoch, else the whole epoch,
    as the JAX package takes it (``DEFAULT_CHUNK`` 0); without it the port's
    default of one step a graph."""
    if env is None:
        monkeypatch.delenv("EOE_TPU_CHUNK", raising=False)
    else:
        monkeypatch.setenv("EOE_TPU_CHUNK", env)
    monkeypatch.setattr(graphs, "DEFAULT_CHUNK", default)
    assert graphs.chunk_steps(steps) == want


def test_resident_epoch_matches_jax(monkeypatch):
    """The forced-resident epoch of the port against the JAX package's
    per-step train step on the port's init and plans (deterministic
    pipeline, SGD): 2 epochs, parameters and BN averages to 1e-5."""
    _force(monkeypatch, True)
    lr, seed = 1e-2, 11
    tr = _trainer(SPECS, lr=lr, sgd=True)
    tr.init_weights(seed)
    init = to_flax_numpy(tr.model.state_dict())
    sampler = B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, T._seed(seed, 1))
    plans = [sampler.epoch() for _ in range(tr.epochs)]
    state, _ = tr.train_cls(tr.ds, 0, "airplane", 0, seed=seed)
    trained = dict(_flat(to_flax_numpy(state.model.state_dict())))

    jt = JaxTrainer(model=JaxCNN32(), train_specs=SPECS, test_specs=SPECS,
                    logger=JaxLogger("", active=False), epochs=2, lr=lr, **COMMON)
    jds = _combined(JB, SPECS)
    variables = jax.tree_util.tree_map(jnp.asarray, init)
    steps = sampler.steps
    tx = jax_make_optimizer("sgd", lr, COMMON["wdk"], COMMON["milestones"], steps)
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step = jax.jit(jt._train_step_core(jds, tx, True))
    x, xo = jds.train_set.gather_all(), jds.oe.train_set.gather_all()
    for idx_n, idx_o, w in plans:
        for s in range(steps):
            jstate, _ = step(jstate, jnp.asarray(x[idx_n[s]]), jnp.zeros(BATCH, jnp.int32),
                             jnp.asarray(xo[idx_o[s]]), jnp.ones(BATCH, jnp.int32),
                             jnp.asarray(w[s], jnp.float32), jax.random.key(0), None, None)
    want = dict(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    assert trained.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(trained[k], v, atol=1e-5, rtol=1e-5, err_msg=str(k))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_vmapped_seeds_resident_equal_per_step(monkeypatch):
    """The stacked seeds (3 members, each with its own generator) through
    the resident epoch: each member's every step loss, train AUROC and
    parameters equal the per-step program's."""
    seeds = [T._seed(0, 0, it, 0) for it in range(3)]
    out = {}
    for resident in (False, True):
        _force(monkeypatch, resident)
        made = _runners(monkeypatch) if resident else []
        tr = _trainer(RANDOM_SPECS, lr=1e-4, sgd=True)
        stack, rocs = V.train_cls_vmapped_seeds(tr, tr.ds, 0, "airplane", 3, seeds)
        out[resident] = (np.array(tr.step_losses).reshape(3, -1), [r.auc for r in rocs],
                         [m[0] for m in stack.host_members()])
        assert [r.chunk for r in made] == ([1] if resident else [])
    (losses, aucs, members), (r_losses, r_aucs, r_members) = out[False], out[True]
    np.testing.assert_allclose(r_losses, losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r_aucs, aucs, atol=RTOL)
    for want, got in zip(members, r_members):
        _assert_state(want, got)


def test_ev_vmap_chunk_resident_equal_per_step(monkeypatch):
    """An ``--ev-vmap`` chunk of three candidates trains every (epoch, step)
    pair through the resident path: each fitness equals the per-step one."""
    args = argparse.Namespace(classes=[0], iterations=1)
    individuals = [[0, 5, 9], [3, 3, 17], [19, 2, 11]]
    fits = {}
    for resident in (False, True):
        _force(monkeypatch, resident)
        made = _runners(monkeypatch) if resident else []
        tr = _trainer(RANDOM_SPECS, lr=1e-3, sgd=True)
        fits[resident] = VmappedEvaluator(tr, args, chunk=3).evaluate_population(individuals)
        assert len(made) == (1 if resident else 0)
    np.testing.assert_allclose(fits[True], fits[False], rtol=RTOL, atol=ATOL)
    assert len(set(np.round(fits[False], 6))) > 1


class _Streamed(B.ArraySource):
    @property
    def resident(self):
        return False


@pytest.mark.parametrize("case,want", [("resident", True), ("streamed_normal", False),
                                       ("streamed_oe", False), ("mesh", True),
                                       ("model_axis", True), ("per_step", False),
                                       ("cpu_default", False)])
def test_resident_path_choice(monkeypatch, case, want):
    """JAX's condition (both halves resident and ``scan_ok``, :787-789),
    which holds under any mesh: on the CPU under ``EOE_TPU_CPU_SCAN=1`` a
    data mesh and a model axis (1 x 2) of gloo ranks take the resident epoch
    with their collectives in the step; a streamed half, the CPU without
    ``EOE_TPU_CPU_SCAN=1`` and the eager control take the per-step loop. On
    the card, tests/test_torch_mesh_resident.py."""
    _force(monkeypatch, case != "cpu_default")
    tr = _trainer(SPECS)
    ds = tr.ds
    if case.startswith("streamed"):
        sub = ds.normal.train_set if case == "streamed_normal" else ds.oe.train_set
        sub.source = _Streamed(sub.source.images, sub.source.targets)
    elif case == "mesh":
        tr.mesh = Mesh(None, "gloo", 0, 2, torch.device("cpu"))
    elif case == "model_axis":
        tr.mesh = Mesh(None, "gloo", 0, 1, torch.device("cpu"), model=2)
    elif case == "per_step":
        tr._per_step = True
    assert tr.resident_epoch(ds) is want
    assert graphs.scan_ok("cpu") is (case != "cpu_default")
    assert graphs.scan_ok("cuda")


def test_images_per_second_and_epochs_only(tmp_path, monkeypatch):
    """``images_seen`` counts the weighted images of ``train_cls``'s epochs
    (JAX: tests/test_trainer.py:244-248), ``train_seconds`` their time;
    ``load_epochs_only`` reads a snapshot's epoch after draining the
    background writer (JAX :95-101)."""
    _force(monkeypatch, True)
    tr = _trainer(SPECS, logger=Logger(str(tmp_path), noname=True, archive_source=False))
    assert tr.images_per_second == 0.0
    state, _ = tr.train_cls(tr.ds, 0, "airplane", 0, seed=3)
    assert tr.images_seen == 2 * 2 * N_NORMAL and tr.train_seconds > 0
    assert tr.images_per_second == pytest.approx(tr.images_seen / tr.train_seconds)
    path = tr.snapshot("snapshot_cls0_it0", state, 7, tr.ds.ds_statistics)
    assert tr.load_epochs_only(path) == 7
    assert tr.load_epochs_only(None) == 0


def test_make_capturable_makes_the_first_updates_state():
    """``make_capturable`` makes the state that the first update would make,
    before any update (so that it is not carved from the first step's freed
    activations on the card): SGD's momentum and Adam's count and moments as
    zeros. Two SGD updates from it equal two from a plain optimizer, zero and
    negative-zero gradients included."""
    torch.manual_seed(0)
    w0 = torch.randn(4, 3)
    grads = [torch.randn(4, 3), torch.randn(4, 3)]
    grads[0][0, 0], grads[0][1, 1] = 0.0, -0.0
    out = []
    for capturable in (False, True):
        w = torch.nn.Parameter(w0.clone())
        opt = make_optimizer("sgd", [w], 0.1, 5e-4, [1], 2)
        if capturable:
            opt.make_capturable()
            assert torch.equal(opt.optimizer.state[w]["momentum_buffer"], torch.zeros(4, 3))
        for g in grads:
            w.grad = g.clone()
            opt.step()
        out.append((w.detach().clone(), opt.optimizer.state[w]["momentum_buffer"].clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])

    w = torch.nn.Parameter(w0.clone())
    adam = make_optimizer("adam", [w], 0.1, 0.0, [1], 2)
    adam.make_capturable()
    st = adam.optimizer.state[w]
    assert adam.optimizer.param_groups[0]["capturable"]
    assert st["step"].dtype == torch.float32 and st["step"].item() == 0
    assert torch.equal(st["exp_avg"], torch.zeros(4, 3))
    assert torch.equal(st["exp_avg_sq"], torch.zeros(4, 3))
