"""The data axis of the port (``eoe_tpu_torch.parallel``) on the CPU: two gloo
ranks, each a process of one thread, against the port's single process and
the JAX package's ``data=2`` mesh of the virtual CPU devices
(tests/conftest.py).

The ranks run once for the module (``_ranks``): this file's ``__main__``
branch, started with EOE_TPU_DISTRIBUTED=1 and the group's address, runs
every case and saves rank 0's results. The cases: three train steps of CNN32
(batch norm) and of a tiny CLIP whose last step's zero-weight tail lies on
rank 1; a batch norm alone; ``Trainer.run``; the seed grid of 4 seeds
(2 + 2), of 3 (2 + 1), of 5 (3 + 2) and of 5 in programs of 2 a rank
(2 + 2, then 1 + none); the evolve evaluator's chunks,
split over the ranks whatever their size. A second launch runs
``train_cifar.main(["-d", "2", ...])``, whose spawned rank writes nothing.
The held steps update with SGD, as in tests/test_torch_conv_trainer.py.
The worker imports no jax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N_NORMAL, N_OE, N_TEST, STEPS, LR = 8, 20, 20, 12, 3, 1e-2
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
SPECS = ["normalize"]
CLIP_HW = 16
CLIP_SPECS = [{"op": "clip_pil_preprocessing", "resolution": CLIP_HW},
              {"op": "clip_tensor_preprocessing"}]
# tests/test_parallel.py's tiny CLIP
CLIP_CFG = dict(embed_dim=32, image_resolution=CLIP_HW, vision_layers=1, vision_width=64,
                vision_patch_size=8, context_length=16, vocab_size=64, transformer_width=32,
                transformer_heads=2, transformer_layers=1, vision_heads_override=2)
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=LR, wdk=1e-3,
              milestones=[], batch_size=BATCH)
INDIVIDUALS = [[0, 5, 9], [3, 3, 17], [19, 2, 11], [7, 14, 1], [3, 3, 17]]
TOL = 1e-5


# ---------------------------------------------------------------- shared cases


def _data(hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))


def _combined(mod, specs, test_specs, hw=32):
    x, xo, xt = _data(hw)
    kw = dict(root="", train_specs=specs, test_specs=test_specs, n_classes=2,
              raw_shape=(hw, hw, 3), ds_statistics=STATS if "normalize" in specs else None)
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    ds = mod.CombinedDataset(normal, oe)
    ds.oe.train_set.valid_indices = np.asarray(ds.oe.train_set.indices).copy()
    return ds


def _plans():
    """Three steps of 8 + 8: the last one holds 4 images and 4 zero-weight
    pads, rows 4-7, which are rank 1's."""
    from eoe_tpu_torch.datasets.bases import BalancedEpochSampler
    idx_n, idx_o, w = BalancedEpochSampler(N_NORMAL, N_OE, BATCH, 7).epoch()
    assert w.shape[0] == STEPS and w[-1, :4].all() and not w[-1, 4:].any()
    return [(idx_n[s], idx_o[s], w[s]) for s in range(STEPS)]


def _models():
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    return {"cnn": (lambda: CNN32(), SPECS, 32),
            "clip": (lambda: CLIP(ClipConfig(**CLIP_CFG),
                                  generator=torch.Generator().manual_seed(0)), CLIP_SPECS,
                     CLIP_HW)}


def _variables(name, state_dict) -> dict:
    """A port state dict as Flax ``{"params", "batch_stats"}`` numpy trees."""
    if name == "clip":
        from eoe_tpu_torch.models.clip.convert import to_flax_variables
        return {"batch_stats": {}, **to_flax_variables(state_dict)}
    from eoe_tpu_torch.models.convert import to_flax_numpy
    return to_flax_numpy(state_dict)


def _steps(name, mesh=None) -> dict:
    """Three SGD steps of model ``name`` on this rank's rows: the global
    losses, scores, the first step's gradients and the last parameters."""
    from eoe_tpu_torch.datasets import bases as B
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import TRAINER, TrainState
    from eoe_tpu_torch.training.optim import make_optimizer

    build, specs, hw = _models()[name]
    tr = TRAINER["hsc"](model=build(), train_specs=specs, test_specs=specs, logger=None,
                        epochs=1, device="cpu", mesh=mesh, **COMMON)
    params = tr._mark_trainable(tr.model)
    state = TrainState(tr.model, make_optimizer("sgd", params, LR, COMMON["wdk"], [], STEPS),
                       tr._data_parallel(tr.model, params))
    ds = _combined(B, specs, specs, hw)
    x, xo, _ = (torch.from_numpy(a) for a in _data(hw))
    lo, hi = meshlib.local_rows(mesh, BATCH)
    out = {"losses": [], "scores": []}
    for s, (i_n, i_o, w) in enumerate(_plans()):
        i_n, i_o, w = i_n[lo:hi], i_o[lo:hi], torch.from_numpy(w[lo:hi])
        loss, scores, *_ = tr.train_step(state, ds, x[i_n], torch.zeros(hi - lo, dtype=torch.int64),
                                         xo[i_o], torch.ones(hi - lo, dtype=torch.int64), w, None)
        if mesh is not None:
            loss = meshlib.all_reduce_sum(loss.reshape(1), mesh)[0]
            scores = meshlib.gather_rows(mesh, scores.reshape(2, -1), BATCH, dim=1).reshape(-1)
        out["losses"].append(float(loss))
        out["scores"].append(scores.numpy())
        if s == 0:
            out["grads"] = {n: p.grad.clone() for n, p in tr.model.named_parameters()
                            if p.grad is not None}
    out["params"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
    return out


def _bn(mesh=None) -> dict:
    """A batch norm in train mode on (16, 4) rows: its averages, output and
    input gradient (gathered)."""
    from eoe_tpu_torch.models.layers import BatchNorm
    from eoe_tpu_torch.parallel import mesh as meshlib
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    lo, hi = meshlib.local_rows(mesh, 16)
    bn = BatchNorm(4, eps=1e-5, momentum=0.9).train()
    xl = x[lo:hi].clone().requires_grad_()
    with meshlib.active(mesh):
        y = bn(xl)
        (y * g[lo:hi]).sum().backward()
    return {"mean": bn.running_mean.clone(), "var": bn.running_var.clone(),
            "y": meshlib.gather_rows(mesh, y.detach(), 16),
            "dx": meshlib.gather_rows(mesh, xl.grad, 16)}


def _grid_trainer(mesh=None, epochs=2):
    """CNN32 on the module's data, 2 epochs of SGD with a milestone between
    them; ``stacks`` records the members of every stacked program it
    makes."""
    from eoe_tpu_torch.datasets import bases as B
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.training.optim import make_optimizer
    tr = TRAINER["hsc"](model=CNN32(), train_specs=SPECS, test_specs=SPECS, logger=None,
                        epochs=epochs, device="cpu", mesh=mesh,
                        **{**COMMON, "lr": 1e-3, "milestones": [1]})
    tr.make_optimizer = lambda params, steps: make_optimizer(
        "sgd", params, 1e-3, COMMON["wdk"], [1], steps)
    tr.ds = _combined(B, SPECS, SPECS)
    tr.stacks, stacked = [], tr.init_states_stacked
    tr.init_states_stacked = lambda seeds, steps: (tr.stacks.append(len(seeds)),
                                                   stacked(seeds, steps))[1]
    return tr


def _run(mesh=None, seeds=1, vmap=False, per=None) -> dict:
    """``Trainer.run`` of the grid; ``per`` fixes the seeds a program holds
    a rank (the memory probe's answer)."""
    from eoe_tpu_torch.training import vmapped_seeds as V
    tr = _grid_trainer(mesh)
    probe = V.seeds_per_program
    if per is not None:
        V.seeds_per_program = lambda *args: per
    try:
        _, res = tr.run(run_classes=[0], run_seeds=seeds, vmap_seeds=vmap)
    finally:
        V.seeds_per_program = probe
    return {"aucs": res["cls_aucs"][0], "losses": list(tr.step_losses),
            "sharded": tr._last_vmap_sharded, "vmapped": tr._last_grid_vmapped,
            "stacks": tr.stacks}


def _evolve(mesh=None) -> dict:
    import argparse
    from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
    tr = _grid_trainer(mesh, epochs=1)
    ev = VmappedEvaluator(tr, argparse.Namespace(classes=[0], iterations=2), chunk=2)
    return {"fits": ev.evaluate_population(INDIVIDUALS), "sharded": tr._last_vmap_sharded,
            "stacks": tr.stacks}


def _cases(mesh=None) -> dict:
    out = {"cnn": _steps("cnn", mesh), "clip": _steps("clip", mesh), "bn": _bn(mesh),
           "run": _run(mesh), "vmap4": _run(mesh, 4, True), "vmap3": _run(mesh, 3, True),
           "vmap5": _run(mesh, 5, True), "evolve": _evolve(mesh)}
    if mesh is not None:   # 5 seeds in programs of 2 a rank: 2 + 2, then 1 + none
        out["vmap5_per2"] = _run(mesh, 5, True, per=2)
    return out


def _spawned(tmp: str) -> dict:
    """``train_cifar`` by ``main`` with ``-d 2`` and with ``-d 1``."""
    from eoe_tpu_torch.main import train_cifar
    out = {}
    for d in ("2", "1"):
        argv = ["-d", d, "-e", "2", "--classes", "0", "-it", "1", "-b", "16",
                "--datapath", tmp, "--superdir", f"d{d}"]
        out[d] = train_cifar.main(argv, device="cpu")[1]["cls_aucs"][0]
    return out


# ---------------------------------------------------------------- the ranks


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", EOE_TPU_FAKE_DATA="1", **extra)
    for k in ("EOE_TPU_DISTRIBUTED", "EOE_TPU_COORD_ADDR", "EOE_TPU_NUM_PROCESSES",
              "EOE_TPU_PROCESS_ID", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(extra)
    return env


def _launch(args, envs, timeout=240, script=__file__):
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), *args], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from eoe_tpu_torch.parallel.mesh import free_port
    tmp = str(tmp_path_factory.mktemp("ranks"))
    addr = f"localhost:{free_port()}"
    envs = [_env(EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr, EOE_TPU_NUM_PROCESSES="2",
                 EOE_TPU_PROCESS_ID=str(i)) for i in range(2)]
    _launch(["cases", tmp], envs)
    return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False), \
        torch.load(os.path.join(tmp, "rank1.pt"), weights_only=False)


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _cases()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spawned"))
    out = _launch(["spawn", tmp], [_env()])[0]
    line = [ln for ln in out.splitlines() if ln.startswith("SPAWNED ")]
    assert line, out[-4000:]
    return tmp, json.loads(line[-1][len("SPAWNED "):])


# ---------------------------------------------------------------- pure functions


def test_mesh_config_resolution():
    from eoe_tpu_torch.parallel import MeshConfig
    assert MeshConfig(data=-1, model=2).resolve(8) == (4, 2)
    with pytest.raises(ValueError):
        MeshConfig(data=8, model=2).resolve(8)


@pytest.mark.parametrize("devices, count, want", [(None, 4, 4), (8, 4, 4), (2, 4, 2),
                                                  (1, 4, 1), (None, 1, 1), (0, 4, 0)])
def test_devices_resolve_as_the_jax_runners(devices, count, want):
    """``-d``: every device by default, at most as many as there are; the
    runners take 1 or less as no mesh (eoe_tpu/main/__init__.py:_make_mesh)."""
    from eoe_tpu_torch.parallel.mesh import data_size
    assert data_size(devices, count) == want


def test_spawn_count_reads_only_devices(monkeypatch):
    from eoe_tpu_torch import main as M
    monkeypatch.delenv("EOE_TPU_DISTRIBUTED", raising=False)
    assert M._spawn_count(["-ds", "cifar10", "-d", "3"], "cpu") == 3
    assert M._spawn_count(["-ds", "cifar10", "--devices", "2", "-e", "1"], "cpu") == 2
    assert M._spawn_count(["-e", "1"], "cpu") == 1            # the CPU: -d alone counts
    assert M._spawn_count(["-d", "4", "--help"], "cpu") == 1
    assert M._spawn_count(["-d", "4"], None) <= max(torch.cuda.device_count(), 1)
    monkeypatch.setenv("EOE_TPU_DISTRIBUTED", "1")
    assert M._spawn_count(["-d", "3"], "cpu") == 1             # the user started the ranks


@pytest.mark.parametrize("n, data, want", [(128, 2, [(0, 64), (64, 128)]),
                                           (7, 2, [(0, 4), (4, 7)]),
                                           (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)])])
def test_local_rows_are_contiguous_blocks(n, data, want):
    """JAX's ``_local_row_range`` of a leading-axis sharding, uneven splits
    included."""
    from eoe_tpu_torch.parallel.mesh import Mesh, local_rows
    assert [local_rows(Mesh(None, "gloo", r, data, torch.device("cpu")), n)
            for r in range(data)] == want
    assert local_rows(None, n) == (0, n)


def test_model_axis_needs_its_ranks():
    """A 1 x 2 mesh needs two ranks; one process has one (the model axis
    itself: tests/test_torch_tensor_parallel.py)."""
    from eoe_tpu_torch.parallel import MeshConfig, make_mesh
    with pytest.raises(ValueError, match="needs 2"):
        make_mesh(MeshConfig(data=1, model=2), "cpu")


def test_init_distributed_noop_without_flag(monkeypatch):
    import warnings
    from eoe_tpu_torch.parallel import mesh as meshlib
    monkeypatch.setattr(meshlib, "_distributed_initialized", False)
    monkeypatch.delenv("EOE_TPU_DISTRIBUTED", raising=False)

    def boom(*a, **k):  # pragma: no cover - must not be called
        raise AssertionError("no group forms without the flag")

    monkeypatch.setattr(meshlib.dist, "init_process_group", boom)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        meshlib.init_distributed()
        meshlib.init_distributed()
    assert not meshlib.dist.is_initialized()


def test_init_distributed_failure_warns(monkeypatch):
    """A group that does not form warns and leaves the process alone, as
    the JAX package's ``init_distributed`` does."""
    from eoe_tpu_torch.parallel import mesh as meshlib
    monkeypatch.setattr(meshlib, "_distributed_initialized", False)
    monkeypatch.setenv("EOE_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("EOE_TPU_COORD_ADDR", "localhost:1")
    monkeypatch.setenv("EOE_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("EOE_TPU_PROCESS_ID", "1")

    def boom(*a, **k):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(meshlib.dist, "init_process_group", boom)
    with pytest.warns(RuntimeWarning, match="continuing single-process"):
        meshlib.init_distributed()
    from eoe_tpu_torch.main import _make_mesh
    assert _make_mesh(None, "cpu") is None


# ---------------------------------------------------------------- two ranks


def _jax_steps(name, capture: bool):
    """The JAX package's step jitted on a data=2 mesh of the virtual CPU
    devices, from the port's initial weights (``to_flax_numpy``): each
    step's loss and scores and the last state. ``capture``: one step whose
    optimizer keeps the gradients as its state."""
    import jax
    import jax.numpy as jnp
    import optax
    from eoe_tpu.datasets import bases as JB
    from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
    from eoe_tpu.models.cnn import CNN32 as JaxCNN32
    from eoe_tpu.parallel import mesh as jmeshlib
    from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
    from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
    from eoe_tpu.utils.logger import Logger as JaxLogger

    build, specs, hw = _models()[name]
    init = _variables(name, build().state_dict())
    jmodel = JaxCNN32() if name == "cnn" else JaxCLIP(JaxConfig(**CLIP_CFG))
    mesh = jmeshlib.make_mesh(jmeshlib.MeshConfig(data=2, model=1))
    jt = JaxTrainer(model=jmodel, train_specs=specs, test_specs=specs, objective="hsc",
                    logger=JaxLogger("", active=False), epochs=1, mesh=mesh, **COMMON)
    jds = _combined(JB, specs, specs, hw)
    variables = jax.tree_util.tree_map(jnp.asarray, init)
    params = variables["params"]
    trainable, _ = jt._split_trainable(params)
    if capture:
        tx = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    else:
        tx = jax_make_optimizer("sgd", LR, COMMON["wdk"], [], STEPS)
    repl, rows = jmeshlib.replicated(mesh), jmeshlib.batch_sharding(mesh, 4)
    state = jax.device_put(JaxState(params=params, batch_stats=variables["batch_stats"],
                                    opt_state=tx.init(trainable),
                                    step=jnp.zeros((), jnp.int32)), repl)
    step = jax.jit(jt._train_step_core(jds, tx, True))
    x, xo, _ = _data(hw)
    out = []
    with mesh:
        for i_n, i_o, w in _plans()[:1 if capture else STEPS]:
            state, (loss, scores, _, _) = step(
                state, jax.device_put(x[i_n], rows), jnp.zeros(BATCH, jnp.int32),
                jax.device_put(xo[i_o], rows), jnp.ones(BATCH, jnp.int32), jnp.asarray(w),
                jax.random.key(0), None, None)
            out.append((float(loss), np.asarray(scores)))
    return out, state


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _as_flax(name, tensors: dict) -> dict:
    """Port tensors (a state dict, or gradients by parameter name) in the
    Flax layout, by path."""
    full = {k: v.clone() for k, v in _models()[name][0]().state_dict().items()}
    full.update(tensors)
    return dict(_flat(_variables(name, full)))


@pytest.mark.parametrize("name", ["cnn", "clip"])
def test_steps_match_jax_data_mesh(ranks, name):
    """Three steps on two ranks (the last step's zero-weight tail on rank 1)
    against the JAX package's step on a data=2 mesh: losses, scores, the
    first step's gradients and the parameters (batch-norm averages
    included) within 1e-5."""
    got = ranks[0][name]
    want, jstate = _jax_steps(name, capture=False)
    for l, s, (jl, js) in zip(got["losses"], got["scores"], want):
        assert abs(l - jl) <= TOL * abs(jl), (l, jl)
        np.testing.assert_allclose(s, js, rtol=TOL, atol=1e-6)
    ours = _as_flax(name, got["params"])
    theirs = dict(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, atol=TOL, err_msg=str(k))
    _, gstate = _jax_steps(name, capture=True)
    grads = _as_flax(name, got["grads"])
    for k, v in _flat({"params": gstate.opt_state}):
        scale = max(float(np.abs(v).max()), 1.0)
        np.testing.assert_allclose(grads[k], v, atol=TOL * scale, err_msg=str(k))


@pytest.mark.parametrize("name", ["cnn", "clip"])
def test_steps_match_one_process(ranks, single, name):
    """The two ranks against the port's one process on the global batch;
    both ranks hold the same parameters."""
    got, want = ranks[0][name], single[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for s, ws in zip(got["scores"], want["scores"]):
        np.testing.assert_allclose(s, ws, rtol=TOL, atol=1e-6)
    for k, v in want["grads"].items():
        torch.testing.assert_close(got["grads"][k], v, atol=TOL * max(v.abs().max(), 1),
                                   rtol=0, msg=k)
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=TOL, rtol=0, msg=k)
        assert torch.equal(ranks[1][name]["params"][k], got["params"][k]), k


def test_batchnorm_global_stats(ranks, single):
    """Batch norm on two ranks takes the global batch's statistics: its
    averages equal the JAX package's flax BatchNorm on the data=2 mesh
    (tests/test_parallel.py's case), its output and input gradient the
    port's one process."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from eoe_tpu.parallel import mesh as jmeshlib

    class BNNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = True):
            return nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)(x)

    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    model = BNNet()
    variables = model.init(jax.random.key(0), jnp.asarray(x), train=False)
    mesh = jmeshlib.make_mesh(jmeshlib.MeshConfig(data=2, model=1))
    _, mut = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jax.device_put(x, jmeshlib.batch_sharding(mesh, 2)))
    stats = mut["batch_stats"]["BatchNorm_0"]
    got = ranks[0]["bn"]
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(stats["mean"]), rtol=TOL,
                               atol=1e-7)
    np.testing.assert_allclose(got["var"].numpy(), np.asarray(stats["var"]), rtol=TOL)
    for k in ("mean", "var", "y", "dx"):
        torch.testing.assert_close(got[k], single["bn"][k], atol=TOL, rtol=TOL, msg=k)


def test_trainer_run_matches_one_process(ranks, single):
    """``Trainer.run`` on two ranks: every step's global loss within 2e-3
    relative of one process's (tests/test_multihost.py's limit), the AUROC
    within 0.01."""
    got, want = ranks[0]["run"], single["run"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3)
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=0.01)
    assert not got["vmapped"] and ranks[1]["run"]["losses"] == got["losses"]


def jax_data_mesh_run(tmp_path, monkeypatch):
    """The JAX package's ``Trainer.run`` of ``_run``'s case on a data=2 mesh,
    from the port's initial weights and sampler plans (the JAX trainer's
    init and sampler seed patched to them; the packages' own random streams
    differ): each epoch's loss and the AUROCs."""
    import jax
    import jax.numpy as jnp
    from eoe_tpu.datasets import bases as JB
    from eoe_tpu.models.cnn import CNN32 as JaxCNN32
    from eoe_tpu.parallel import mesh as jmeshlib
    from eoe_tpu.training import trainer as JT
    from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
    from eoe_tpu.utils.logger import Logger as JaxLogger
    from eoe_tpu_torch.datasets.bases import BalancedEpochSampler
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training.trainer import _seed

    seed = _seed(0, 0, 0, 0)   # the port's class 0, seed 0, first attempt
    model = CNN32()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    init = jax.tree_util.tree_map(jnp.asarray, _variables("cnn", model.state_dict()))
    plans = BalancedEpochSampler(N_NORMAL, N_OE, BATCH, _seed(seed, 1))
    monkeypatch.setattr(JT, "BalancedEpochSampler", lambda n, o, b, _: JB.BalancedEpochSampler(
        n, o, b, _seed(seed, 1)))
    assert all(np.array_equal(a, b) for a, b in zip(
        plans.epoch(), JB.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, _seed(seed, 1)).epoch()))

    logger = JaxLogger(str(tmp_path), noname=True, archive_source=False)
    jt = JT.Trainer(model=JaxCNN32(), train_specs=SPECS, test_specs=SPECS, objective="hsc",
                    logger=logger, epochs=2, mesh=jmeshlib.make_mesh(
                        jmeshlib.MeshConfig(data=2, model=1)),
                    **{**COMMON, "lr": 1e-3, "milestones": [1]})
    jt.make_optimizer = lambda steps: jax_make_optimizer("sgd", 1e-3, COMMON["wdk"], [1], steps)
    jt.init_state = lambda key, ds, steps: JT.TrainState(
        params=init["params"], batch_stats=init["batch_stats"],
        opt_state=jt.make_optimizer(steps).init(init["params"]), step=jnp.zeros((), jnp.int32))
    jt.ds = _combined(JB, SPECS, SPECS)
    _, res = jt.run(run_classes=[0], run_seeds=1)
    return [v for _, v in logger._scalars["training_cls0_seed0_loss"]], res["cls_aucs"][0]


def epoch_losses(losses: list, epochs: int = 2) -> list:
    """Every epoch's mean of a run's step losses."""
    steps = len(losses) // epochs
    return [float(np.mean(losses[e * steps:(e + 1) * steps])) for e in range(epochs)]


def test_trainer_run_matches_jax_data_mesh(ranks, tmp_path, monkeypatch):
    """``Trainer.run`` on two ranks against the JAX package's ``Trainer.run``
    on a data=2 mesh (``jax_data_mesh_run``): each epoch's loss within 2e-3
    relative, the AUROC within 0.01."""
    jax_losses, jax_aucs = jax_data_mesh_run(tmp_path, monkeypatch)
    got = ranks[0]["run"]
    np.testing.assert_allclose(epoch_losses(got["losses"]), jax_losses, rtol=2e-3)
    np.testing.assert_allclose(got["aucs"], jax_aucs, atol=0.01)


def test_seed_grid_shards_over_ranks(ranks, single):
    """4 seeds over 2 ranks: each rank trains 2 (no collective in a step),
    every seed's AUROC and loss that of one process's vmapped grid, on both
    ranks."""
    got, want = ranks[0]["vmap4"], single["vmap4"]
    assert got["vmapped"] and got["sharded"] and not want["sharded"]
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=2e-3)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    assert ranks[1]["vmap4"]["aucs"] == got["aucs"]


@pytest.mark.parametrize("seeds, shares", [(3, [[2], [1]]), (5, [[3], [2]]),
                                           (5, [[2, 1], [2]])])
def test_indivisible_seed_grid_splits_unevenly(ranks, single, seeds, shares):
    """3 seeds on 2 ranks train 2 + 1, 5 train 3 + 2, each rank's share as
    one stacked program; 5 in programs of 2 a rank train 2 + 2, then 1 on
    rank 0 and nothing on rank 1 (an empty share: no program, no scores,
    its gathers of no rows). Every rank logs every seed's AUROC and losses,
    and those are one process's."""
    # ``shares``: each rank's programs' members; several programs: of
    # shares[0][0] seeds a rank (``_run``'s ``per``)
    per = shares[0][0] if len(shares[0]) > 1 else None
    case = f"vmap{seeds}" + (f"_per{per}" if per else "")
    got, want = ranks[0][case], single[f"vmap{seeds}"]
    assert want["stacks"] == [seeds] and not want["sharded"]
    for rank, members in zip(ranks, shares):
        r = rank[case]
        assert r["vmapped"] and r["sharded"] and r["stacks"] == members
        assert len(r["aucs"]) == seeds and r["aucs"] == got["aucs"]
        assert r["losses"] == got["losses"]
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)


def test_evolve_chunks_shard_over_ranks(ranks, single):
    """Five candidates in chunks of two, over two iterations: every chunk
    splits over the ranks, the last one (of one candidate) too, so no rank
    trains a whole chunk; the fitnesses are one process's, on both
    ranks."""
    got, want = ranks[0]["evolve"], single["evolve"]
    assert got["sharded"] and not want["sharded"]
    assert want["stacks"] == [2, 2, 1] * 2
    assert got["stacks"] == [1, 1, 1] * 2 and ranks[1]["evolve"]["stacks"] == [1, 1] * 2
    np.testing.assert_allclose(got["fits"], want["fits"], atol=TOL)
    assert ranks[1]["evolve"]["fits"] == got["fits"]


def test_devices_flag_spawns_a_silent_rank(spawned):
    """``train_cifar.main(["-d", "2", ...])`` starts one more rank, trains
    with the numbers of ``-d 1`` and writes one run directory."""
    tmp, aucs = spawned
    runs = {d: os.listdir(os.path.join(tmp, "results", f"d{d}")) for d in ("1", "2")}
    assert len(runs["2"]) == 1 and len(runs["1"]) == 1, runs
    run = os.path.join(tmp, "results", "d2", runs["2"][0])
    assert os.path.exists(os.path.join(run, "results.json"))
    with open(os.path.join(run, "print.txt")) as f:
        assert "data mesh: rank 0 of 2 on cpu, collectives on gloo" in f.read()
    losses = []
    for d in ("2", "1"):
        with open(os.path.join(tmp, "results", f"d{d}", runs[d][0], "scalars.json")) as f:
            losses.append([v for _, v in json.load(f)["training_cls0_seed0_loss"]])
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-3)
    np.testing.assert_allclose(aucs["2"], aucs["1"], atol=0.01)


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, tmp = sys.argv[1], sys.argv[2]
    sys.path.insert(0, REPO)
    if mode == "spawn":
        print("SPAWNED " + json.dumps(_spawned(tmp)), flush=True)
    else:
        from eoe_tpu_torch.parallel import mesh as meshlib
        meshlib.init_distributed()
        mesh = meshlib.make_mesh(meshlib.MeshConfig(data=2), "cpu")
        out = _cases(mesh)
        torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))
        meshlib.leave()
