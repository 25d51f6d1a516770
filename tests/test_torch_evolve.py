"""The port's evolutionary OE search (``eoe_tpu_torch.evolve``, the evolve
functions of ``eoe_tpu_torch.main`` and the five runners) against the JAX
package's, on the CPU.

The GA's decisions draw from one numpy PCG64 generator in both packages, so
with the same seed and the same fitness values they must be the same: the
populations, fitness history and genealogy tree of three generations are
held equal, for subsets of one image (mating picks an image "in between"
the parents by pixel distance) and of three (mating swaps elements). The
OE pool's images are built so that the distances that compete in one pick
lie at least 1e-3 apart relative to each other: the two packages sum the
squared differences in different orders, and a pick must not hang on the
last bits. The stub fitness is a fixed function of the individual, so no
training runs in those holds; ``evaluate_individual`` is held on its own
with a tiny CNN32 run."""

import argparse
import importlib
import json
import os
import os.path as pt
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import eoe_tpu.evolve as J
import eoe_tpu.evolve.tree as JT
import eoe_tpu.main as jax_main
import eoe_tpu_torch.evolve as P
import eoe_tpu_torch.evolve.tree as PT
import eoe_tpu_torch.main as port_main
from eoe_tpu.datasets import bases as JB
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.utils.logger import Logger

N_POOL, HW, REGION = 40, 64, 300   # OE images, their side, pixels each one lights

RUNNERS = ["evolve_oe_cifar", "evolve_oe_imagenet", "evolve_oe_custom", "random_oe_cifar",
           "random_oe_imagenet"]


def _pool_images() -> np.ndarray:
    """Image k is 0 but for its own run of REGION values at level 150 + 2.5k:
    the squared distance of images i != j is w_i + w_j (w_k = REGION *
    (level_k / 255)^2, from 104 to 283), above ``SELF_DIST``; the distances
    from one image to the others differ by w, whose consecutive ratios exceed
    1.026."""
    flat = np.zeros((N_POOL, HW * HW * 3), np.uint8)
    for k in range(N_POOL):
        flat[k, k * REGION:(k + 1) * REGION] = int(150 + 2.5 * k)
    return flat.reshape(N_POOL, HW, HW, 3)


def _oeds(mod):
    return mod.Subset(mod.ArraySource(_pool_images(), np.zeros(N_POOL)), np.arange(N_POOL))


def test_pool_distances_are_well_separated():
    x = _pool_images().reshape(N_POOL, -1).astype(np.float64) / 255.0
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    rows = [d[i] for i in range(N_POOL)] + [d[i] + d[j] for i in range(N_POOL)
                                             for j in range(i + 1, N_POOL)]
    for row in rows:
        vals = np.unique(row[row > 0])
        assert (vals[1:] / vals[:-1]).min() > 1 + 1e-3
    assert d[d > 0].min() > P.SELF_DIST


def _fitness(ind) -> float:
    return ((sum((i + 1) * v for i, v in enumerate(ind)) * 7919) % 1009) / 1009.0


def _canonical_tree(path: str, logdir: str) -> dict:
    """evolution.json with the random UUIDs replaced by node positions and
    the files relative to the run directory."""
    with open(path) as f:
        tree = json.load(f)
    pos = {n["uuid"]: i for i, n in enumerate(tree["nodes"])}
    nodes = [{**n, "uuid": pos[n["uuid"]],
              "file": None if n["file"] is None else pt.relpath(n["file"], logdir)}
             for n in tree["nodes"]]
    return {"nodes": nodes, "edges": [[pos[p], pos[c]] for p, c in tree["edges"]]}


def _run_ga(side: str, logdir: str, oesize: int, generations: int = 3):
    ev, main, mod = (J, jax_main, JB) if side == "jax" else (P, port_main, B)
    logger = (JaxLogger if side == "jax" else Logger)(logdir, noname=True, archive_source=False)
    oeds = _oeds(mod)
    trainer = SimpleNamespace(oe_dsstr="tinyimages", device=torch.device("cpu"))
    pop, _, toolbox, history, tree = main.evolve_setup(
        oesize, 8, 12, 1.0 if oesize == 1 else 0.5, 3, 0.5, 0.5, generations, 3, trainer, oeds,
        argparse.Namespace(), True, seed=11)
    toolbox.register("evaluate", _fitness)
    ev.evaluate(pop, pop, 0, toolbox, history, tree, oeds, logger)
    for gen in range(1, generations):
        ev.evolve(pop, gen, toolbox, 0.5, 0.5, history, tree, oeds, logger, seed=11)
    logger.drain()
    return history, tree


@pytest.mark.parametrize("oesize", [1, 3])
def test_ga_decisions_match_jax(oesize, tmp_path):
    """Three generations with the same seed and fitness: equal populations,
    fitness history and genealogy."""
    runs = {side: _run_ga(side, str(tmp_path / side), oesize) for side in ("jax", "port")}
    (jh, _), (ph, _) = runs["jax"], runs["port"]
    assert ph["pop"] == jh["pop"] and ph["fit"] == jh["fit"]
    assert ph["setup"] == jh["setup"]
    assert len({tuple(map(tuple, p)) for p in ph["pop"]}) == 3   # the generations differ
    for k in ("mean_fit", "std_fit", "min_fit", "max_fit"):
        assert ph[k] == jh[k]
    trees = [_canonical_tree(str(tmp_path / s / "evolution.json"), str(tmp_path / s))
             for s in ("jax", "port")]
    assert trees[0] == trees[1]
    assert len(trees[0]["nodes"]) > 8 + 1   # generation 0, the root and offspring
    for sub in ("individuals", "raw_gen", "selection"):
        assert sorted(os.listdir(tmp_path / "port" / sub)) == \
            sorted(os.listdir(tmp_path / "jax" / sub))


def test_mutation_distances_and_picks_match_jax():
    """One mutation's distances (fp32, images scaled to [0, 1]) and its pick
    among the k nearest, from the same draws."""
    ind = [3, 17, 30]
    jd = np.asarray(((J._gather_f32(_oeds(JB), ind)[:, None]
                      - J._gather_f32(_oeds(JB), range(N_POOL))[None]) ** 2).sum(-1))
    pd = P._sq_dists(P._gather_f32(_oeds(B), ind, "cpu"),
                     P._gather_f32(_oeds(B), range(N_POOL), "cpu"))
    assert pd.dtype == np.float32
    np.testing.assert_allclose(pd, jd, rtol=1e-6)
    picks = []
    for ev in (J, P):
        ev.seed_evolution(5)
        picks.append([ev._nearest_excl_self(row, 4) for row in (pd if ev is P else jd)])
    assert picks[0] == picks[1] and all(p != i for p, i in zip(picks[0], ind))


def test_rand_pick_and_random_replacement_match_jax():
    out = []
    for ev, main, mod in ((J, jax_main, JB), (P, port_main, B)):
        oeds = _oeds(mod)
        trainer = SimpleNamespace(oe_dsstr="x", device=torch.device("cpu"))
        pop, gen, toolbox, history, _ = main.rand_pick_setup(2, 6, trainer, oeds,
                                                            argparse.Namespace(), seed=3)
        redrawn = toolbox.select([ev.Individual(list(i)) for i in pop], len(pop))
        ev.seed_evolution(9)
        again = ev.replace_individuals_randomly([ev.Individual([0, 0, 0])] * 4, oeds=oeds)
        out.append(([list(i) for i in pop], gen, history, [list(i) for i in redrawn],
                    [list(i) for i in again], [i.fitness.weight for i in again]))
    assert out[0] == out[1]


def _tree(mod):
    roots = [mod.EvolNode(mod.Individual([i, i + 1], fitness=f)) for i, f in
             enumerate([0.3, 0.7, 0.5])]
    tree = mod.Tree(*roots)
    kids = [mod.EvolNode(mod.Individual([9, 1], f"/runs/gen001_ind00{i}.png", 0.7 + i * 0.1))
            for i in range(2)]
    roots[0].add_children(*kids)
    roots[1].add_children(kids[1])
    kids[1].add_children(mod.EvolNode(mod.Individual([1, 2], fitness=None)))
    return tree


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_round_trips_between_packages(writer, tmp_path):
    """evolution.json written by one package loads in the other: the same
    JSON again, the same traversals, lookups and top-k."""
    w, r = (JT, PT) if writer == "jax" else (PT, JT)
    _tree(w).save(str(tmp_path / "a"))
    loaded = r.Tree().load(str(tmp_path / "a.json"))
    loaded.save(str(tmp_path / "b"))
    assert json.load(open(tmp_path / "a.json")) == json.load(open(tmp_path / "b.json"))
    again = w.Tree().load(str(tmp_path / "b.json"))
    for t1, t2 in ((loaded, again), (r.Tree().load(str(tmp_path / "a.json")), loaded)):
        assert [n.uuid for n in t1.bfs()] == [n.uuid for n in t2.bfs()]
        assert [n.uuid for n in t1.dfs()] == [n.uuid for n in t2.dfs()]
    for best in (True, False):
        assert [n.uuid for n in loaded.topk(3, best)] == [n.uuid for n in again.topk(3, best)]
    best = loaded.topk(2)   # the duplicate [9, 1] at 0.7 is dropped, the unscored node too
    assert [n.content.values for n in best] == [[9, 1], [1, 2]]
    assert [n.content.fitness for n in best] == pytest.approx([0.8, 0.7])
    assert [n.content.values for n in loaded.topk(8, best=False)] == [[0, 1], [2, 3], [1, 2],
                                                                      [9, 1]]
    assert loaded.get([9, 1]).uuid == again.get([9, 1]).uuid
    assert loaded.get([5, 5]) is None


def test_tree_render_and_overviews(tmp_path):
    """The genealogy and the best/worst overviews are drawn where matplotlib
    imports (here), from the OE pool's images."""
    tree = _tree(PT)
    logger = Logger(str(tmp_path), noname=True, archive_source=False)
    assert tree.render(str(tmp_path / "genealogy.png"), oeds=_oeds(B)) is not None
    tree.imsave_collection_best(logger, (), oeds=_oeds(B), k=2)
    logger.drain()
    for name in ("genealogy", "overview_best", "overview_worst"):
        assert pt.getsize(tmp_path / f"{name}.png") > 0


def _write_history(side: str, path: str, oesize: int):
    """An interrupted evolution run as the runner leaves it: results.json,
    evolution.json, and an inner run directory with its trainer's setup."""
    history, tree = _run_ga(side, path, oesize, generations=2)
    logger_cls = JaxLogger if side == "jax" else Logger
    logger_cls(path, noname=True, archive_source=False).logjson("results", history)
    inner = logger_cls(pt.join(path, "log_20260101000000"), noname=True, archive_source=False)
    kw = dict(train_specs=["normalize"], test_specs=["normalize"], dataset="cifar10",
              oe_dataset="tinyimages", datapath="", logger=inner, epochs=3, lr=1e-3, wdk=0,
              milestones=[25], batch_size=128)
    if side == "jax":
        from eoe_tpu.models.cnn import CNN32 as JaxCNN32
        from eoe_tpu.training import TRAINER as JAX_TRAINER
        JAX_TRAINER["hsc"](model=JaxCNN32(), **kw)
    else:
        from eoe_tpu_torch.models import CNN32
        from eoe_tpu_torch.training import TRAINER
        TRAINER["hsc"](model=CNN32(), device="cpu", **kw)
    inner.logsetup({"run_classes": [0], "run_seeds": 2, "load": None}, step=1)
    return history


def _resume(side: str, run: str, logdir: str):
    """``load_evolve`` of one package on ``run``; (population, fitness,
    generation, arguments) as loaded, and the toolbox's pieces."""
    ev, main, mod, logger_cls, tree_mod = ((J, jax_main, JB, JaxLogger, JT) if side == "jax"
                                           else (P, port_main, B, Logger, PT))
    oeds = _oeds(mod)
    trainer = SimpleNamespace(oe_dsstr="tinyimages", device=torch.device("cpu"))
    args = argparse.Namespace(dataset="cifar10", objective="hsc", ev_minimize_fitness=False,
                              ev_seed=0, ev_vmap=False)
    tree = tree_mod.Tree()
    template = main._make_history(
        oesize=0, geneation_pool=0, mutation_pool=0, mutation_indp=0, mutation_oneofkbest=0,
        mutation_chance=0, mate_chance=0, generations=0, oeds="", select_toursize=0,
        ev_seed=None)
    logger = logger_cls(logdir, noname=True, archive_source=False)
    history, pop, gen, _, toolbox = main.load_evolve(
        run, tree, template, [], 0, logger, trainer, oeds, args, ["normalize"], ["normalize"])
    loaded = ([list(i) for i in pop], [i.fitness.values for i in pop], gen, dict(vars(args)))
    return loaded, (ev, pop, toolbox, history, tree, oeds, logger, args)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_evolve_resumes_the_other_package(writer, tmp_path):
    """Each package resumes the other's interrupted run (subsets of three
    images): the loaded configuration, the last generation's population
    with its fitness, and the next generation drawn as the writer would have
    drawn it. Here the first tree node of each individual has its fitness,
    where the JAX package reads it (see the next test)."""
    run = str(tmp_path / "run")
    written = _write_history(writer, run, 3)
    with open(pt.join(run, "evolution.json")) as f:
        nodes = json.load(f)["nodes"]
    assert all(next(n for n in nodes if n["values"] == v)["fitness"] is not None
               for v in written["pop"][-1])
    out = {}
    for side in ("jax", "port"):
        loaded, (ev, pop, toolbox, history, tree, oeds, logger, args) = _resume(
            side, run, str(tmp_path / side))
        toolbox.register("evaluate", _fitness)
        ev.evolve(pop, loaded[2], toolbox, args.ev_mate_chance, args.ev_mutation_chance,
                  history, tree, oeds, logger, seed=args.ev_seed)
        logger.drain()
        out[side] = loaded, history["pop"][-1], history["fit"][-1]
    assert out["port"] == out["jax"]
    (pop, fits, gen, args), _, _ = out["port"]
    assert pop == written["pop"][-1] and [f[0] for f in fits] == written["fit"][-1]
    assert gen == 2 and args["ev_generation_pool"] == 8 and args["ev_seed"] == 11
    assert args["epochs"] == 3 and args["iterations"] == 2 and args["milestones"] == [25]


def test_load_evolve_takes_the_fitness_from_the_history(tmp_path):
    """Where an individual's values occur in more than one tree node (subsets
    of one image from a pool of 40), ``evaluate`` gives the fitness to the
    latest node at the time. The JAX package resumes with the first node's
    fitness, here None, on which its next selection fails; the port takes the
    history's last row and resumes."""
    run = str(tmp_path / "run")
    written = _write_history("jax", run, 1)
    (_, jax_fits, _, _), _ = _resume("jax", run, str(tmp_path / "jax"))
    assert (None,) in jax_fits
    (pop, fits, gen, _), (ev, pop_, toolbox, history, tree, oeds, logger, args) = _resume(
        "port", run, str(tmp_path / "port"))
    assert pop == written["pop"][-1] and [f[0] for f in fits] == written["fit"][-1]
    toolbox.register("evaluate", _fitness)
    ev.evolve(pop_, gen, toolbox, args.ev_mate_chance, args.ev_mutation_chance, history,
              tree, oeds, logger, seed=args.ev_seed)
    assert len(history["pop"]) == 3


def test_evaluate_individual_pins_the_oe_pool(tmp_path, monkeypatch):
    """A tiny CNN32 run: during the run the OE split is the individual's
    images alone, every OE half comes from them, and the full pool is back
    afterwards."""
    from eoe_tpu_torch.models import CNN32
    trainer, oeds, logger = port_main.evolve_trainer(
        "hsc", "", "cifar10", "cifar100", 1, 1e-3, 0.0, [], 16, "one_vs_rest", None,
        CNN32(rep_dim=16), ["normalize"], ["normalize"], classes=[0],
        dataset_path=str(tmp_path), superdir=str(tmp_path), device="cpu")
    P.ensure_valid_indices(oeds)
    full = oeds.indices.copy()
    ind = P.Individual([5, 1])
    allowed = {oeds.gather(np.array([i])).tobytes() for i in ind}
    seen = []
    step = trainer.train_step

    def spy(state, ds, xn, ln, xo, *a, **kw):
        seen.append((len(ds.oe.train_set), [x.numpy().tobytes() for x in xo]))
        return step(state, ds, xn, ln, xo, *a, **kw)

    monkeypatch.setattr(trainer, "train_step", spy)
    fit = P.evaluate_individual(ind, trainer, argparse.Namespace(classes=[0], iterations=1),
                                None)
    assert 0.0 <= fit <= 1.0
    assert seen and all(n == 2 for n, _ in seen)
    assert all(x in allowed for _, xs in seen for x in xs)
    assert {x for _, xs in seen for x in xs} == allowed
    np.testing.assert_array_equal(oeds.indices, full)
    assert trainer.oe_limit_samples == [5, 1]
    assert pt.isdir(logger.dir) and pt.samefile(pt.dirname(trainer.logger.dir), logger.dir)


def test_ev_vmap_is_not_ported(tmp_path, monkeypatch):
    """``--ev-vmap`` registers ``VmappedEvaluator.evaluate_population``: the
    runner evaluates each generation through it (held against the
    sequential runs in tests/test_torch_vmapped_evolve.py), never through
    ``evaluate_individual``."""
    from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
    from eoe_tpu_torch.main import evolve_oe_cifar
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    calls = []
    monkeypatch.setattr(VmappedEvaluator, "evaluate_population",
                        lambda self, inds: calls.append(inds) or [0.5] * len(inds))
    monkeypatch.setattr(port_main, "evaluate_individual", None)
    history, _ = evolve_oe_cifar.main(
        ["-e", "1", "-it", "1", "--oe-dataset", "cifar100", "--datapath", str(tmp_path),
         "--superdir", str(tmp_path), "--ev-vmap", "--ev-generations", "2",
         "--ev-generation-pool", "4", "--ev-mutation-pool", "8"], device="cpu")
    assert len(calls) == 2 and len(calls[0]) == 4 and history["fit"][0] == [0.5] * 4


def test_chunked_distances_keep_the_ga_decisions(tmp_path, monkeypatch):
    """The mutation and mating distances in chunks smaller than the
    mutation pool (12): equal distances, and three generations with the
    JAX package's decisions."""
    monkeypatch.setattr(P, "DIST_CHUNK", 5)
    ids = list(range(N_POOL))
    a = P._gather_f32(_oeds(B), [3, 17, 30], "cpu")
    np.testing.assert_array_equal(P._candidate_dists(a, _oeds(B), ids, "cpu"),
                                  P._sq_dists(a, P._gather_f32(_oeds(B), ids, "cpu")))
    for oesize in (1, 3):
        (jh, _), (ph, _) = (_run_ga(side, str(tmp_path / f"{side}{oesize}"), oesize)
                            for side in ("jax", "port"))
        assert ph["pop"] == jh["pop"] and ph["fit"] == jh["fit"]


EV_ARGVS = [
    [],
    ["--ev-generations", "3", "--ev-oesize", "2", "--ev-minimize-fitness", "--classes", "3",
     "-it", "1", "--ev-mutation-pool", "50", "--ev-seed", "7"],
    ["--ev-vmap", "--ms-mode", "lpf+train_nominal", "--magnitude", "3", "--comment",
     "{obj}-{classes}-{its}-{admode}", "-oe", "none", "--compute-dtype", "bfloat16"],
    ["--oe-size", "5"],     # refused
    ["--load", "/runs/x"],  # refused
]
RAND_ARGVS = [[], ["--ev-samples", "4", "--ev-oesize", "3", "--classes", "2", "-e", "2"],
              ["--ev-seed", "5", "--ms-mode", "blur+train_oe"], ["--oe-size", "5"]]


class _Parsed(Exception):
    pass


def _parsed(parser_owner, trainer_owner, parser_name, main, argv, monkeypatch):
    """The namespace a runner hands to ``evolve_trainer`` (which is stopped
    there), or the runner's own refusal."""
    captured = []
    parse = getattr(parser_owner, parser_name)
    monkeypatch.setattr(parser_owner, parser_name,
                        lambda *a, **kw: captured.append(parse(*a, **kw)) or captured[-1])

    def stop(*a, **kw):
        raise _Parsed()

    monkeypatch.setattr(trainer_owner, "evolve_trainer", stop)
    try:
        main(argv)
    except _Parsed:
        out = dict(vars(captured[-1]))
        out["ms_mode"] = [str(m) for m in out["ms_mode"]]
        return out
    except ValueError as e:
        return type(e), str(e)
    finally:
        monkeypatch.undo()
    raise AssertionError("the runner did not reach evolve_trainer")


@pytest.mark.parametrize("runner", RUNNERS)
def test_runner_parses_as_jax(runner, capsys, monkeypatch):
    """Defaults, pipelines and model as the JAX runner's; for every argv the
    same namespace (comment included) or the same refusal."""
    ours = importlib.import_module(f"eoe_tpu_torch.main.{runner}")
    theirs = importlib.import_module(f"eoe_tpu.main.{runner}")
    assert ours.DEFAULTS == theirs.DEFAULTS
    assert ours.TRAIN_SPECS == theirs.TRAIN_SPECS and ours.TEST_SPECS == theirs.TEST_SPECS
    evolve = runner.startswith("evolve")
    parser_name = "evolve_argsparse" if evolve else "ms_argsparse"
    for argv in EV_ARGVS if evolve else RAND_ARGVS:
        got = _parsed(port_main, port_main, parser_name, ours.main, argv, monkeypatch)
        want = _parsed(theirs, theirs, parser_name, theirs.main, argv, monkeypatch)
        assert got == want, argv
        if isinstance(got, dict):
            args = argparse.Namespace(**got)
            model, jax_model = ours.build_model(args), theirs.build_model(args)
            assert type(model).__name__ == type(jax_model).__name__
            assert model.clf == jax_model.clf


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def test_logimg_matches_jax(tmp_path):
    """The grid's pixels: gutters, columns, row headers, grey for c = 1, and
    floats clipped to [0, 1] before the uint8 cast."""
    rng = np.random.default_rng(0)
    cases = {
        "rgb": (rng.integers(0, 256, (7, 9, 8, 3), dtype=np.uint8), 3, None),
        "headers": (rng.integers(0, 256, (6, 12, 12, 3), dtype=np.uint8), 2,
                    ["0: 13", "1: 7", "long header"]),
        "grey": (rng.normal(0.5, 0.6, (5, 6, 6, 1)).astype(np.float32), 4, None),
        "grey_headers": (rng.random((4, 16, 16, 1)), 2, ["a", "b"]),
    }
    jl = JaxLogger(str(tmp_path / "jax"), noname=True, archive_source=False)
    pl = Logger(str(tmp_path / "port"), noname=True, archive_source=False)
    for name, (imgs, nrow, headers) in cases.items():
        jl.logimg(pt.join("sub", name), imgs, nrow=nrow, rowheaders=headers)
        pl.logimg(pt.join("sub", name), torch.from_numpy(np.asarray(imgs)) if name == "grey"
                  else imgs, nrow=nrow, rowheaders=headers)
    jl.drain()
    pl.drain()
    for name in cases:
        want = _png(tmp_path / "jax" / "sub" / f"{name}.png")
        got = _png(tmp_path / "port" / "sub" / f"{name}.png")
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert _png(tmp_path / "port" / "sub" / "grey.png").ndim == 2
    off = Logger(str(tmp_path / "off"), noname=True, active=False)
    off.logimg("x", cases["rgb"][0])
    assert not pt.exists(tmp_path / "off")
