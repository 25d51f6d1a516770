"""Evolutionary search for the best (or worst) Outlier Exposure samples: the
port of eoe_tpu/evolve/__init__.py.

An individual is a list of positions into the OE train subset, with a
fitness (the mean test AUC of a full ``trainer.run`` with only those OE
images) and the file of its image grid. One generation selects (a
tournament of ``tournsize`` with replacement, or a random redraw for the
random-search baseline), mates (size-1 subsets take an image "in between"
both parents, nearest to both; larger subsets swap elements), mutates (each
element replaced by one of the ``oneofkbest`` nearest of ``poolsize`` random
candidates, the sample itself excluded by distance > ``SELF_DIST``) and
evaluates the changed offspring (``evolve``). ``evaluate`` records the
history and the genealogy tree and writes the grids of the individuals,
generations, selections, matings and mutations. Where the toolbox holds an
``evaluate_population`` (``evolve.vmapped.VmappedEvaluator``), the whole
set of offspring without a fitness goes through it in one call.

Every stochastic decision draws from one module-level numpy ``Generator``
(PCG64), reseeded by ``seed_evolution`` and, per generation, from (seed,
gen), as in the JAX package: with the same seed and the same fitness values
both packages make the same decisions. The pixel distances of mutation and
mating are computed on the trainer's device (the card unless the caller asks
for the CPU) as ``((a[:, None] - b[None]) ** 2).sum(-1)`` in fp32 over
images scaled to [0, 1], the JAX package's formula; the expanded
||a||^2 + ||b||^2 - 2ab form would cancel digits and could reorder near
neighbours. The candidates are gathered, moved and compared ``DIST_CHUNK``
at a time, which bounds the memory at a large mutation pool; each distance
is still its own sum, so the chunking moves no pick.
"""

import copy
import os
import os.path as pt
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from eoe_tpu_torch.device import resolve_device
from eoe_tpu_torch.evolve.tree import EvolNode, Individual as TreeIndividual, Tree

SELF_DIST = 100.0  # distances at most this are taken for the sample itself
DIST_CHUNK = 256   # candidates per chunk of the mutation and mating distances

_rng: np.random.Generator = np.random.default_rng()


def seed_evolution(seed) -> np.random.Generator:
    """Reset the evolution PRNG. ``seed`` is an int or a sequence of ints
    (``np.random.SeedSequence`` entropy); None draws OS entropy."""
    global _rng
    _rng = np.random.default_rng(seed)
    return _rng


class Fitness:
    def __init__(self, weight: float = 1.0):
        self.weight = weight
        self._values: Optional[Tuple[float, ...]] = None

    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, v):
        self._values = tuple(v)

    @values.deleter
    def values(self):
        self._values = None

    @property
    def valid(self):
        return self._values is not None

    @property
    def weighted(self):
        return self._values[0] * self.weight if self.valid else None


class Individual(list):
    """A list of OE-subset positions with a fitness and an image file."""

    def __init__(self, values, weight: float = 1.0):
        super().__init__(values)
        self.fitness = Fitness(weight)
        self.file = None


class Toolbox:
    """A registry of named operators with fixed keyword arguments."""

    def __init__(self):
        self._ops = {}

    def register(self, name, fn, **fixed):
        self._ops[name] = (fn, fixed)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn, fixed = self._ops[name]
        return lambda *a, **k: fn(*a, **{**fixed, **k})

    def clone(self, obj):
        if isinstance(obj, Individual):
            new = Individual(list(obj), obj.fitness.weight)
            new.fitness._values = obj.fitness._values
            new.file = obj.file
            return new
        return copy.deepcopy(obj)


# ---------------------------------------------------------------- samples


def _gather_f32(oeds, ids: Sequence[int], device) -> torch.Tensor:
    """OE-subset samples as flat fp32 rows on ``device``, uint8 scaled to
    [0, 1]."""
    imgs = oeds.gather(np.asarray(list(ids), dtype=np.int64) % len(oeds))
    x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device).float()
    if imgs.dtype == np.uint8:
        x = x / 255.0
    return x.reshape(x.shape[0], -1)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Squared distances of every row of ``a`` to every row of ``b``."""
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1).cpu().numpy()


def _candidate_dists(a: torch.Tensor, oeds, ids: Sequence[int], device) -> np.ndarray:
    """Squared distances of every row of ``a`` to the OE-subset samples
    ``ids``, ``DIST_CHUNK`` candidates at a time."""
    return np.concatenate([_sq_dists(a, _gather_f32(oeds, ids[i:i + DIST_CHUNK], device))
                           for i in range(0, len(ids), DIST_CHUNK)], axis=1)


def _nearest_excl_self(dists: np.ndarray, oneofkbest: int) -> int:
    """Position of a random pick among the ``oneofkbest`` nearest with a
    distance above ``SELF_DIST``."""
    order = np.argsort(dists)
    vals = dists[order]
    start = next((a for a in range(len(vals)) if vals[a] > SELF_DIST), 0)
    c = int(_rng.integers(start, start + oneofkbest))
    return int(order[min(c, len(order) - 1)])


# ---------------------------------------------------------------- operators


def init_individual(oeds) -> int:
    """A random position into the OE subset."""
    ensure_valid_indices(oeds)
    return int(_rng.integers(0, len(oeds.valid_indices)))


def ensure_valid_indices(oeds):
    """Keep the full OE index set once: individuals index into it while
    ``indices`` is pinned to one individual per run."""
    if not hasattr(oeds, "valid_indices"):
        oeds.valid_indices = np.asarray(oeds.indices).copy()


def evaluate_individual(individual, trainer, args, toolbox) -> float:
    """A full training run with the individual as the only OE; the fitness is
    the mean test AUC. The trainer's logger goes quiet once its run
    directory holds more than five entries."""
    if trainer.logger.active and len(os.listdir(trainer.logger.dir)) > 5:
        trainer.logger.active = False
    trainer.oe_limit_samples = list(individual)
    if trainer.ds is not None:
        oeds = trainer.ds.oe.train_set
        oeds.indices = np.asarray([oeds.valid_indices[i] for i in individual], np.int64)
    try:
        res = trainer.run(args.classes, args.iterations)[1]["mean_auc"]
    finally:
        if trainer.ds is not None:
            oeds.indices = np.asarray(oeds.valid_indices).copy()
    return float(res)


def mutate_individual(ind, oeds, poolsize: int, indp: float, oneofkbest: int, device=None):
    """Replace each element (with probability ``indp``) by one of the
    ``oneofkbest`` nearest of ``poolsize`` random candidates."""
    if poolsize <= 0:
        return (ind,)
    device = resolve_device(device)
    samples = _gather_f32(oeds, ind, device)
    new_ids = [int(_rng.integers(0, len(oeds))) for _ in range(poolsize)]
    d = _candidate_dists(samples, oeds, new_ids, device)
    for n in range(len(ind)):
        if _rng.random() < indp:
            ind[n] = new_ids[_nearest_excl_self(d[n], oneofkbest)]
    return (ind,)


def _match_samples(samples1: torch.Tensor, samples2: torch.Tensor) -> List[int]:
    """The assignment of the second parent's samples to the first's with the
    least total distance, by exhaustive search."""
    d = _sq_dists(samples1, samples2)

    def ms(dm):
        if dm.shape[0] == 1:
            return float(dm[0, 0]), [0]
        results = []
        for b in range(dm.shape[1]):
            sub = np.concatenate([dm[1:, :b], dm[1:, b + 1:]], axis=1)
            cost, picks = ms(sub)
            results.append((float(dm[0, b]) + cost,
                            [b] + [p if p < b else p + 1 for p in picks]))
        return min(results, key=lambda r: r[0])

    return ms(d)[1]


def mate_individuals(ind1, ind2, oeds, poolsize: int, indp: float, oneofkbest: int,
                     device=None):
    """Size-1 subsets: each parent's element is replaced (with probability
    ``indp``) by a candidate near both parents' images; larger subsets swap
    elements."""
    if poolsize <= 0:
        return ind1, ind2
    if len(ind1) == 1:
        device = resolve_device(device)
        s1 = _gather_f32(oeds, ind1, device)
        s2 = _gather_f32(oeds, ind2, device)
        match = _match_samples(s1, s2)
        for n, b in zip(range(s1.shape[0]), match):
            pair = torch.stack([s1[n], s2[b]])
            for ind in (ind1, ind2):
                if _rng.random() < indp:
                    new_ids = [int(_rng.integers(0, len(oeds))) for _ in range(poolsize)]
                    d = _candidate_dists(pair, oeds, new_ids, device).sum(0)
                    ind[n] = new_ids[_nearest_excl_self(d, oneofkbest)]
    else:
        for i in range(len(ind1)):
            if _rng.random() < indp:
                ind1[i], ind2[i] = ind2[i], ind1[i]
    return ind1, ind2


def replace_individuals_randomly(individuals, k=None, oeds=None):
    """The random-search baseline's "selection": every individual redrawn."""
    for n in range(len(individuals)):
        individuals[n] = Individual(
            [int(_rng.integers(0, len(oeds.valid_indices)))
             for _ in range(len(individuals[n]))],
            individuals[n].fitness.weight)
    return individuals


def select_individual(individuals, k, tournsize, replace=False):
    """``k`` tournaments of ``tournsize`` aspirants each."""
    chosen = []
    for _ in range(k):
        aspirants = [individuals[i] for i in
                     _rng.choice(len(individuals), tournsize, replace)]
        chosen.append(max(aspirants, key=lambda ind: ind.fitness.weighted))
    return chosen


# ---------------------------------------------------------------- generations


def _pop_grid(oeds, pop) -> np.ndarray:
    ids = [i for ind in pop for i in ind]
    return oeds.gather(np.asarray(ids, np.int64) % len(oeds))


def evaluate(offspring, pop, gen: int, toolbox, history: dict, tree: Tree, oeds, logger):
    """Evaluate the offspring without a fitness, then record the generation
    in ``history`` and ``tree``, its grids and its statistics. With a
    registered ``evaluate_population`` the offspring without a fitness are
    evaluated in one call."""
    invalid = [ind for ind in offspring if not ind.fitness.valid]
    invalid_ids = {id(ind) for ind in invalid}   # identity: equal values may differ in fitness
    prefits = None
    if "evaluate_population" in toolbox._ops and invalid:
        logger.print(f"Evaluate {len(invalid)} individuals (vmapped)..")
        prefits = dict(zip(map(id, invalid),
                           toolbox.evaluate_population([list(ind) for ind in invalid])))
    for i, ind in enumerate(offspring):
        if id(ind) not in invalid_ids:
            continue
        if prefits is not None:
            fit = prefits[id(ind)]
        else:
            logger.print(f"Evaluate ind{i:03}..")
            fit = toolbox.evaluate(ind)
        name = f"gen{gen:03}_ind{i:03}_fit{fit * 100:06.3f}"
        logger.logimg(pt.join("individuals", name), oeds.gather(
            np.asarray(list(ind), np.int64) % len(oeds)), nrow=16)
        logger.logtxt(f"{name} with ids {list(ind)}")
        ind.fitness.values = [fit]
        node = tree.get(ind)
        if node is not None:
            node.content.file = pt.join(logger.dir, "individuals", f"{name}.png")
            node.content.fitness = fit

    pop[:] = offspring
    fits = [ind.fitness.values[0] for ind in pop]
    mean, std = float(np.mean(fits)), float(np.std(fits))
    minf, maxf = float(np.min(fits)), float(np.max(fits))
    history["pop"].append([list(ind) for ind in pop])
    history["fit"].append(fits)
    history["mean_fit"].append(mean)
    history["std_fit"].append(std)
    history["min_fit"].append(minf)
    history["max_fit"].append(maxf)
    logger.logimg(pt.join("raw_gen", f"gen{gen:03}"), _pop_grid(oeds, pop),
                  nrow=max(len(pop[0]), 1))
    logger.print(f"GENERATION {gen:03}")
    logger.print(f"  Min {minf * 100:06.3f}")
    logger.print(f"  Max {maxf * 100:06.3f}")
    logger.print(f"  Avg {mean * 100:06.3f}")
    logger.print(f"  Std {std * 100:06.3f}")
    logger.add_scalar("avg_fit", mean * 100, gen)
    logger.add_scalar("max_fit", maxf * 100, gen)
    if logger.active:
        tree.save(pt.join(logger.dir, "evolution"))


def evolve(pop, gen: int, toolbox, mate_chance: float, mutation_chance: float,
           history: dict, tree: Tree, oeds, logger, log_mutations: bool = True,
           seed: Optional[int] = None):
    """One generation: select -> mate -> mutate -> evaluate. With ``seed``
    the generation draws from (seed, gen), so a resumed run draws what the
    uninterrupted one would have."""
    if seed is not None:
        seed_evolution((seed, gen))
    logger.print("-------------------------------------------------------")
    logger.print(f"-------------------GENERATION {gen:03}----------------------")
    logger.print("-------------------------------------------------------")
    nrow = max(len(pop[0]), 1) if len(pop[0]) > 1 else len(pop)

    offspring = toolbox.select(pop, len(pop))
    offspring = list(map(toolbox.clone, offspring))
    if log_mutations:
        logger.logimg(pt.join("selection", f"gen{gen:03}"),
                      np.concatenate([_pop_grid(oeds, pop), _pop_grid(oeds, offspring)]),
                      nrow=nrow)

    before = list(map(toolbox.clone, offspring))
    picked = []
    for i, (c1, c2) in enumerate(zip(offspring[::2], offspring[1::2])):
        if _rng.random() < mate_chance:
            n1, n2 = tree.get(c1), tree.get(c2)
            toolbox.mate(c1, c2)
            del c1.fitness.values
            del c2.fitness.values
            picked.append(i)
            cn1, cn2 = EvolNode(TreeIndividual(list(c1))), EvolNode(TreeIndividual(list(c2)))
            if n1 is not None:
                n1.add_children(cn1, cn2)
            if n2 is not None and n2 is not n1:
                n2.add_children(cn1, cn2)
    if log_mutations and picked:
        logger.logimg(pt.join("mating", f"gen{gen:03}"),
                      np.concatenate([_pop_grid(oeds, before), _pop_grid(oeds, offspring)]),
                      nrow=nrow)

    before = list(map(toolbox.clone, offspring))
    picked = []
    for i, mutant in enumerate(offspring):
        if _rng.random() < mutation_chance:
            node = tree.get(mutant)
            toolbox.mutate(mutant)
            del mutant.fitness.values
            picked.append(i)
            child = EvolNode(TreeIndividual(list(mutant)))
            if node is not None:
                node.add_children(child)
    if log_mutations and picked:
        logger.logimg(pt.join("mutation", f"gen{gen:03}"),
                      np.concatenate([_pop_grid(oeds, before), _pop_grid(oeds, offspring)]),
                      nrow=nrow)

    evaluate(offspring, pop, gen, toolbox, history, tree, oeds, logger)
