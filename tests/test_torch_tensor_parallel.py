"""The model axis of the port's mesh (``eoe_tpu_torch.parallel``) on the CPU:
eight gloo ranks, each a process of one thread, as a data=4 x model=2 mesh,
against the port's single process and the JAX package's 4 x 2 mesh of the
virtual CPU devices (tests/conftest.py), and ``param_shardings`` against the
JAX package's.

The ranks run once for the module (``ranks``): this file's ``__main__``
branch, started with EOE_TPU_DISTRIBUTED=1 and the group's address, runs the
cases on the 4 x 2 mesh and saves each rank's results: the placement of the
ranks, a shard/gather round trip, two epochs of tests/test_parallel.py's
tiny CLIP (HSC, CLIP's test preprocessing so that both packages see the same
images; the weights are the JAX package's, carried across with
``convert.from_flax``), a ``ClipTrainer.run`` with a random flip (its
snapshot served and resumed) and a seed grid. Then ranks 0-3 form a 2 x 2
mesh and ranks 4-5 a data mesh of two, and each runs
tests/test_torch_parallel.py's three CNN32 steps. The worker imports no jax.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import _env, _launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, N, EPOCHS, LR = 16, 8, 32, 2, 1e-3
SPECS = [{"op": "clip_pil_preprocessing", "resolution": HW}, {"op": "clip_tensor_preprocessing"}]
# tests/test_parallel.py's tiny CLIP: widths a model axis of 2 divides
CLIP_CFG = dict(embed_dim=32, image_resolution=HW, vision_layers=1, vision_width=64,
                vision_patch_size=8, context_length=16, vocab_size=64, transformer_width=32,
                transformer_heads=2, transformer_layers=1, vision_heads_override=2)
# a CLIP that takes the tokenizer's prompts (ClipTrainer), both towers split
PROMPT_CFG = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
                  vision_patch_size=8, context_length=77, vocab_size=49408,
                  transformer_width=128, transformer_heads=2, transformer_layers=2,
                  vision_heads_override=2)
RUN_SPECS = [{"op": "random_hflip"}, {"op": "clip_pil_preprocessing"},
             {"op": "clip_tensor_preprocessing"}]
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=LR, wdk=0.0,
              milestones=[], batch_size=B)
TOL = 1e-5


# ---------------------------------------------------------------- shared cases


def _combined(mod, hw=HW, specs=SPECS, test_specs=SPECS):
    """tests/test_parallel.py's data: 32 normal and 32 OE images, 16 test."""
    rng = np.random.default_rng(7)
    kw = dict(root="", train_specs=specs, test_specs=test_specs, n_classes=2,
              raw_shape=(hw, hw, 3))
    xtr = rng.integers(0, 256, (N, hw, hw, 3), np.uint8)
    xte = rng.integers(0, 256, (2 * B, hw, hw, 3), np.uint8)
    xoe = rng.integers(0, 256, (N, hw, hw, 3), np.uint8)
    normal = mod.GenericADDataset(mod.ArraySource(xtr, np.zeros(N, np.int64)),
                                  mod.ArraySource(xte, np.array([0, 1] * B, np.int64)),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xoe, np.ones(N, np.int64)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def _clip(weights: dict, mesh=None) -> dict:
    """Two epochs of HSC on the tiny CLIP from ``weights``: every step's
    loss, the train and eval AUROCs, the test scores and the full trained
    parameters."""
    from eoe_tpu_torch.datasets import bases as B_
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import Trainer

    tr = Trainer(model=CLIP(ClipConfig(**CLIP_CFG)), objective="hsc", train_specs=SPECS,
                 test_specs=SPECS, logger=None, epochs=EPOCHS, device="cpu", mesh=mesh, **COMMON)
    tr.init_weights = lambda seed: tr.model.load_state_dict(weights)
    ds = _combined(B_)
    state, roc = tr.train_cls(ds, 0, "t", 0, 0)
    eroc, _ = tr.eval_cls(state, ds, 0, "t", 0)
    params, shardings = state.model.state_dict(), tr._shardings(state)
    assert (shardings is not None) == (mesh is not None)
    if shardings is not None:   # a copy of the model holds this rank's heads
        params = meshlib.gather_params(mesh, params, shardings)
        attn = state.model.visual.transformer.blocks[0].attn
        assert state.model is not tr.model and attn.tp is mesh and attn.qkv.weight.shape[0] == 96
    return {"losses": list(tr.step_losses), "auroc": roc.auc, "eval_auroc": eroc.auc,
            "scores": tr.eval_scores(state, ds),
            "params": {k: v.detach().clone() for k, v in params.items()}}


def _prompt_weights() -> dict:
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    return CLIP(ClipConfig(**PROMPT_CFG), generator=torch.Generator().manual_seed(3)).state_dict()


def _clip_run(logdir: str, mesh=None, active=True) -> dict:
    """``ClipTrainer.run`` of one epoch with a random flip: its losses, test
    scores and AUROC, the snapshot, and (under a mesh) a resumed state's
    largest distance from it."""
    from eoe_tpu_torch.datasets import bases as B_
    from eoe_tpu_torch.models.clip import ClipConfig
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training.clip import ClipTrainer
    from eoe_tpu_torch.utils.logger import Logger

    logger = Logger(logdir, noname=True, active=active, tensorboard=False, archive_source=False)
    tr = ClipTrainer(None, RUN_SPECS, [], logger=logger,
                     epochs=1, device="cpu", mesh=mesh, clip_state_dict=_prompt_weights(),
                     clip_config=ClipConfig(**PROMPT_CFG), **COMMON)
    tr.ds = _combined(B_, 32, tr.train_specs, tr.test_specs)
    _, res = tr.run(run_classes=[0])
    out = {"losses": list(tr.step_losses), "aucs": res["cls_aucs"][0],
           "snapshot": os.path.join(logdir, "snapshots", "snapshot_cls0_it0.pt"),
           "scores_file": os.path.join(logdir, "eval_cls0_it0_anomaly_scores.json")}
    if mesh is not None:   # a resumed run cuts the full snapshot to this rank's shards
        import torch.distributed as dist
        dist.barrier()   # world rank 0 has written it
        snap = torch.load(out["snapshot"], weights_only=True)
        state, epoch = tr._init_or_load(tr.ds, 0, out["snapshot"], 4)
        shardings = tr._shardings(state)
        full = meshlib.gather_params(mesh, state.model.state_dict(), shardings)
        moment = tr._opt_tensors(state.model, state.optimizer.state_dict(), shardings,
                                 meshlib.gather_tensor)
        out["resumed"] = max(float((full[k] - v).abs().max()) for k, v in snap["params"].items())
        out["resumed_opt"] = max(
            float((st["momentum_buffer"] - snap["opt_state"]["optimizer"]["state"][i][
                "momentum_buffer"]).abs().max())
            for i, st in moment["optimizer"]["state"].items())
        out["resumed_epoch"] = epoch
    return out


def _grid(mesh=None) -> dict:
    """Four CNN32 seeds as one vmapped program."""
    from test_torch_parallel import _run
    return _run(mesh, 4, True)


# ---------------------------------------------------------------- the ranks


def _rank_cases(tmp: str, weights: dict) -> dict:
    """Every case on the 4 x 2 mesh, this rank's results."""
    import torch.distributed as dist
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=4, model=2), "cpu")
    rank = dist.get_rank()
    out = {"place": (rank, mesh.rank, mesh.model_rank, mesh.size), "note": mesh.note}
    model = CLIP(ClipConfig(**PROMPT_CFG), generator=torch.Generator().manual_seed(1))
    full = model.state_dict()
    full["visual.transformer.blocks.0.attn.qkv.weight"][5, :3] = -0.0   # signed zeros
    shardings = meshlib.param_shardings(mesh, model)
    back = meshlib.gather_params(mesh, meshlib.shard_params(mesh, full, shardings), shardings)
    out["round_trip"] = all(torch.equal(back[k].reshape(-1).view(torch.uint8),
                                        v.reshape(-1).view(torch.uint8)) for k, v in full.items())
    out["split"] = sorted(k for k, v in shardings.items() if v is not None)
    out["clip"] = _clip(weights, mesh)
    # the snapshot of a model-axis run, written by world rank 0, then resumed
    run = os.path.join(tmp, "run")
    out["run"] = _clip_run(run, mesh, active=rank == 0)
    out["grid"] = _grid(mesh)
    meshlib.leave()
    return out


def _pair_cases(rank: int) -> dict:
    """Ranks 0-3 as a 2 x 2 mesh, ranks 4-5 as a data mesh of two: three
    CNN32 steps each (tests/test_torch_parallel.py's)."""
    from eoe_tpu_torch.parallel import mesh as meshlib
    from test_torch_parallel import _steps
    if rank >= 6:
        return {}
    config, addr, world, sub = ((meshlib.MeshConfig(data=2, model=2), "TP_ADDR_MESH", 4, rank)
                                if rank < 4 else
                                (meshlib.MeshConfig(data=2), "TP_ADDR_DATA", 2, rank - 4))
    meshlib._init_group(os.environ[addr], world, sub)
    mesh = meshlib.make_mesh(config, "cpu")
    out = {"cnn": _steps("cnn", mesh), "model": mesh.model}
    meshlib.leave()
    return out


def _jax_init(key, cfg: dict):
    """The JAX package's CLIP ``cfg`` at its init, both towers (an init
    through ``__call__`` makes only the image tower's)."""
    import jax.numpy as jnp
    from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
    res, ctx = cfg["image_resolution"], cfg["context_length"]
    return JaxCLIP(JaxConfig(**cfg)).init(key, jnp.zeros((1, res, res, 3)),
                                          jnp.zeros((1, ctx), jnp.int32),
                                          method="contrastive")["params"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's tiny CLIP at its init, as JAX params and the port's
    state dict (``from_flax``)."""
    import jax
    from eoe_tpu_torch.models.clip.convert import from_flax
    params = jax.jit(lambda k: _jax_init(k, CLIP_CFG))(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("weights") / "clip.pt")
    torch.save(from_flax(params), path)
    return params, path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    from eoe_tpu_torch.parallel.mesh import free_port
    tmp = str(tmp_path_factory.mktemp("ranks"))
    addr = f"localhost:{free_port()}"
    pairs = {"TP_ADDR_MESH": f"localhost:{free_port()}",
             "TP_ADDR_DATA": f"localhost:{free_port()}"}
    envs = [_env(EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr, EOE_TPU_NUM_PROCESSES="8",
                 EOE_TPU_PROCESS_ID=str(i), **pairs) for i in range(8)]
    _launch(["cases", tmp, weights[1]], envs, timeout=300, script=__file__)
    return [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False)
            for i in range(8)], tmp


@pytest.fixture(scope="module")
def single(weights, tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sd = torch.load(weights[1], weights_only=True)
        yield {"clip": _clip(sd), "run": _clip_run(str(tmp_path_factory.mktemp("one"))),
               "grid": _grid()}
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------- pure functions


def _jax_specs(cfg: dict, m: int) -> dict:
    """The JAX package's ``param_shardings`` of CLIP ``cfg`` on a mesh with a
    model axis of ``m`` (shapes only), by Flax path: the mapped dims."""
    import jax
    import jax.numpy as jnp
    from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
    from eoe_tpu.parallel import mesh as jmeshlib
    shapes = jax.eval_shape(lambda k: _jax_init(k, cfg), jax.random.key(0))
    mesh = jmeshlib.make_mesh(jmeshlib.MeshConfig(data=8 // m, model=m))
    specs = jmeshlib.param_shardings(mesh, shapes)
    return {tuple(p.key for p in path): tuple(d for d, ax in enumerate(spec.spec) if ax)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: hasattr(x, "spec"))}


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["tiny", "vit_b32"])
def test_param_shardings_are_jaxs(name, m):
    """The port splits the parameters JAX splits, along the same dimension
    (the transposed one of a ``Linear.weight``), except the recorded
    deviation: ``qkv`` and ``attn_out`` stay whole where the model size does
    not divide the heads (ViT-B/32's 12 at 3 and 4 are split; its text
    tower's 8 at 3 is not, where JAX splits 3 x 512 and not 512)."""
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32, ClipConfig
    from eoe_tpu_torch.models.clip.convert import _to_flax
    from eoe_tpu_torch.parallel.mesh import Mesh, param_shardings
    cfg = CLIP_CFG if name == "tiny" else {
        f: getattr(VIT_B32, f) for f in ClipConfig.__dataclass_fields__}
    with torch.device("meta"):
        model = CLIP(ClipConfig(**cfg))
    ours = param_shardings(Mesh(None, "gloo", 0, 1, torch.device("cpu"), model=m), model)
    theirs = _jax_specs(cfg, m)
    deviations = 0
    for key, split in ours.items():
        p = model.get_parameter(key)
        _, path, _ = _to_flax(key, np.empty(p.shape, np.float32))
        want = theirs[tuple(path)]
        got = () if split is None else ((1 - split[0],) if p.ndim == 2 else (split[0],))
        if got != want:
            module = model.get_submodule(key.rsplit(".", 2)[0])
            assert split is None and path[-2] in ("qkv", "attn_out") and module.heads % m, \
                (key, got, want)
            deviations += 1
    heads = {cfg.get("vision_heads_override") or cfg["vision_width"] // 64,
             cfg["transformer_heads"]}
    assert bool(deviations) == any(h % m for h in heads)
    assert len(ours) == len(theirs)


@pytest.mark.parametrize("m", [2, 3])
def test_shards_put_back_are_the_tensor(m):
    """Each model rank's ``shard_tensor``, placed where ``gather_tensor``
    places it, gives the tensor back bit for bit; ``qkv``'s shards are a
    rank's heads of q, k and v."""
    from eoe_tpu_torch.parallel.mesh import Mesh, shard_tensor
    t = torch.randn(3 * 6 * 4, 6)
    meshes = [Mesh(None, "gloo", 0, 1, torch.device("cpu"), model=m, model_rank=j)
              for j in range(m)]
    for split in ((0, 3), (0, 1), (1, 1)):
        parts = [shard_tensor(t, split, mesh) for mesh in meshes]
        assert all(p.shape[split[0]] * m == t.shape[split[0]] for p in parts)
        blocks = [p.unflatten(split[0], (split[1], -1)) for p in parts]
        back = torch.stack(blocks, split[0] + 1).flatten(split[0], split[0] + 2)
        assert torch.equal(back, t), split
    q, k, v = t.chunk(3)
    per = q.shape[0] // m
    assert torch.equal(shard_tensor(t, (0, 3), meshes[1]),
                       torch.cat([q[per:2 * per], k[per:2 * per], v[per:2 * per]]))


# ---------------------------------------------------------------- eight ranks


def test_ranks_sit_as_jax_places_them(ranks):
    """World rank r at data index r // 2 and model index r % 2, as JAX's
    ``reshape(data, model)`` of the devices; shard and gather give every
    tensor back bit for bit (signed zeros too); the split parameters are
    both towers' qkv, attn_out, mlp_up and mlp_down (not the biases added
    after a reduction)."""
    got, _ = ranks
    assert [r["place"] for r in got] == [(i, i // 2, i % 2, 8) for i in range(8)]
    assert got[3]["note"].startswith("4 x 2 mesh: rank 3 of 8 (data 1, model 1) on cpu, "
                                     "collectives on gloo")
    assert all(r["round_trip"] for r in got)
    split = got[0]["split"]
    assert len(split) == 4 * 6   # 4 blocks x qkv (2), attn_out, mlp_up (2), mlp_down
    assert not any(k.endswith(("attn_out.bias", "mlp_down.bias")) for k in split)


def _jax_run(params):
    """The JAX package's train_cls and eval_cls on its 4 x 2 mesh of the
    virtual devices, from ``params`` and the port's sampler seed: each
    step's loss, the AUROCs and the trained parameters."""
    import jax
    import jax.numpy as jnp
    from eoe_tpu.datasets import bases as JB
    from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
    from eoe_tpu.parallel import mesh as jmeshlib
    from eoe_tpu.training import trainer as JT
    from eoe_tpu.utils.logger import Logger as JaxLogger
    from eoe_tpu_torch.training.trainer import _seed

    mesh = jmeshlib.make_mesh(jmeshlib.MeshConfig(data=4, model=2))
    jt = JT.Trainer(model=JaxCLIP(JaxConfig(**CLIP_CFG)), objective="hsc", train_specs=SPECS,
                    test_specs=SPECS, logger=JaxLogger("", active=False), epochs=EPOCHS,
                    mesh=mesh, **{**COMMON, "datapath": "/tmp"})

    def init_state(key, ds, steps):
        placed = jt.place_params(jax.tree_util.tree_map(jnp.asarray, params))
        tx = jt.make_optimizer(steps)
        return JT.TrainState(params=placed, batch_stats={},
                             opt_state=tx.init(jt._split_trainable(placed)[0]),
                             step=jnp.zeros((), jnp.int32))

    losses, fetch = [], jt._fetch

    def fetched(x):   # the per-step path downloads each step's loss alone
        out = fetch(x)
        if np.ndim(out) == 0:
            losses.append(float(out))
        return out

    jt.init_state, jt._fetch = init_state, fetched
    sampler = JT.BalancedEpochSampler
    JT.BalancedEpochSampler = lambda n, o, b, _: JB.BalancedEpochSampler(n, o, b, _seed(0, 1))
    try:
        ds = _combined(JB)
        with mesh:
            state, roc = jt.train_cls(ds, 0, "t", 0, jax.random.key(0))
            eroc, _ = jt.eval_cls(state, ds, 0, "t", 0)
    finally:
        JT.BalancedEpochSampler = sampler
    return {"losses": losses, "auroc": roc.auc, "eval_auroc": eroc.auc,
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


def test_clip_training_matches_jax_and_one_process(ranks, single, weights):
    """Two epochs on the 4 x 2 mesh against the JAX package's 4 x 2 run and
    the port's one process (tests/test_parallel.py's limits): every step's
    loss 1e-5, the parameters rtol 2e-4 and atol 1e-5, the AUROCs 0.01; on
    every rank."""
    from eoe_tpu_torch.models.clip.convert import to_flax_numpy
    got = [r["clip"] for r in ranks[0]]
    want, jax_run = single["clip"], _jax_run(weights[0])
    assert len(want["losses"]) == len(jax_run["losses"]) == EPOCHS * N // B
    for g in got:
        for ref in (want, jax_run):
            np.testing.assert_allclose(g["losses"], ref["losses"], rtol=TOL, atol=TOL)
            assert abs(g["auroc"] - ref["auroc"]) < 0.01
            assert abs(g["eval_auroc"] - ref["eval_auroc"]) < 0.01
        for k, v in want["params"].items():
            torch.testing.assert_close(g["params"][k], v, rtol=2e-4, atol=TOL, msg=k)
        np.testing.assert_allclose(g["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    ours = to_flax_numpy(got[0]["params"])
    import jax
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_run["params"]):
        node = ours
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, leaf, rtol=2e-4, atol=TOL, err_msg=str(path))
    assert not np.array_equal(ours["visual"]["proj"], weights[0]["visual"]["proj"])


def test_snapshot_serves_and_resumes_whole(ranks, single):
    """``ClipTrainer.run`` with a random flip on the 4 x 2 mesh: its losses,
    scores and AUROC are one process's (every model rank of a data index
    drew the same flips); world rank 0 wrote full tensors, which
    ``AnomalyScorer`` serves as one process's run scores (1e-4); a resumed
    state cut from the snapshot gathers back to it, momentum included."""
    import json
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.training.clip import CLIP_SPECS, prompt_center
    got, tmp = ranks
    run, want = got[0]["run"], single["run"]
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(run["aucs"], want["aucs"], atol=1e-4)
    with open(run["scores_file"]) as f, open(want["scores_file"]) as g:
        ours, theirs = json.load(f), json.load(g)
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), rtol=1e-4, atol=1e-4)
    snap = torch.load(run["snapshot"], weights_only=True)
    cfg = ClipConfig(**PROMPT_CFG)
    assert all(v.shape == w.shape for v, w in zip(snap["params"].values(),
                                                  _prompt_weights().values()))
    model = CLIP(cfg)
    model.load_state_dict(_prompt_weights())
    center = prompt_center(model, "airplane", (), device="cpu")
    scorer = AnomalyScorer(run["snapshot"], CLIP(cfg), objective="clip", center=center,
                           test_specs=[dict(CLIP_SPECS[0], resolution=32), CLIP_SPECS[1]],
                           batch_size=B, device="cpu")
    from eoe_tpu_torch.datasets import bases as B_
    ds = _combined(B_, 32)
    scores = scorer.score(ds.test_set.gather_all())
    np.testing.assert_allclose(scores, list(theirs.values()), rtol=1e-4, atol=1e-4)
    for r in got:
        assert r["run"]["resumed"] == 0 and r["run"]["resumed_opt"] == 0
        assert r["run"]["resumed_epoch"] == 1


def test_seed_grid_runs_whole_under_a_model_axis(ranks, single):
    """Four seeds on a data axis of four are not split under a model axis
    (the JAX package's ``shard_seeds``): every rank trains all four on the
    whole model, as one process does."""
    got, want = ranks[0][5]["grid"], single["grid"]
    assert got["vmapped"] and not got["sharded"]
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=2e-3)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)


def test_conv_model_replicates_over_the_model_axis(ranks):
    """CNN32 matches no rule: under 2 x 2 its three steps are the data mesh
    of two's, parameters and batch-norm averages within 1e-5, on both
    model ranks."""
    got = ranks[0]
    want = got[4]["cnn"]
    assert got[0]["model"] == 2 and got[4]["model"] == 1
    for r in got[:4]:
        np.testing.assert_allclose(r["cnn"]["losses"], want["losses"], rtol=TOL)
        for k, v in want["params"].items():
            torch.testing.assert_close(r["cnn"]["params"][k], v, atol=TOL, rtol=0, msg=k)
    assert any("running" in k for k in want["params"])


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from eoe_tpu_torch.parallel import mesh as meshlib
    tmp, weights_path = sys.argv[2], sys.argv[3]
    meshlib.init_distributed()
    world_rank = int(os.environ["EOE_TPU_PROCESS_ID"])
    out = _rank_cases(tmp, torch.load(weights_path, weights_only=True))
    out.update(_pair_cases(world_rank))
    torch.save(out, os.path.join(tmp, f"rank{world_rank}.pt"))
