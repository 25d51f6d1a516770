"""Vectorised fitness of the evolutionary OE search: the port of
eoe_tpu/evolve/vmapped.py.

``evaluate_individual`` trains one candidate OE subset per full run. Here K
candidates train as one program (``training.vmapped_seeds.StackedState``):

  * every candidate of an iteration starts from the iteration's init, the
    one the sequential run of that seed draws, so init noise does not enter
    the comparison;
  * the normal half of every batch, its augmentation draws and the DSVDD
    centre are shared; only the OE half differs, one (K, oesize, h, w, c)
    pool of the candidates' images gathered by each candidate's positions;
  * each candidate's test AUROC is computed on the card by
    ``torch.func.vmap`` of ``ops.metrics.auroc_torch`` over the shared test
    batches' scores.

The fitness is the mean AUROC over ``args.iterations`` seeds of
``args.classes[0]``, which is what the sequential ``trainer.run`` of each
candidate gives. Candidates train ``chunk`` at a time, or as many as the
card holds where that is fewer (``training.vmapped_seeds.members_per_program``,
from one step of one and of two candidates; under a data mesh the least
over the ranks). Under a data mesh of several ranks without a model axis
every chunk is split over the ranks (``trainer._last_vmap_sharded``), each
training its ``local_rows`` of the candidates with no collective: an
uneven share where the data size does not divide the chunk, none where the
chunk is shorter than the ranks (the JAX package runs such a chunk whole on
every device; a candidate's numbers are one process's either way). The
fitnesses are gathered, so every rank holds every fitness and makes the
same GA decisions. Under a model axis every chunk runs whole on every
rank, as in the JAX package. Needs the pinned, resident dataset that
``evolve_trainer`` builds. Where ``trainer.resident_epoch(ds,
stacked=True)`` holds (the card under any mesh, or
``EOE_TPU_CPU_SCAN=1``), a chunk trains every (epoch, step) pair through
``training.graphs.ResidentSteps`` over the plans of every epoch packed on
the device, as the JAX package's ``train_full`` scans them.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from eoe_tpu_torch.datasets import str_labels
from eoe_tpu_torch.datasets.bases import BalancedEpochSampler, CombinedDataset
from eoe_tpu_torch.ops.metrics import auroc_torch
from eoe_tpu_torch.parallel import mesh as meshlib
from eoe_tpu_torch.training import graphs
from eoe_tpu_torch.training.trainer import TrainState, _seed
from eoe_tpu_torch.training.vmapped_seeds import (members_per_program, preprocess_members,
                                                  probe_steps)


class VmappedEvaluator:
    """Evaluates a population of OE-position individuals in chunks of
    ``chunk`` candidates."""

    def __init__(self, trainer, args, chunk: int = 16):
        assert trainer.ds is not None, "vmapped evaluation needs the pinned dataset"
        self.trainer = trainer
        self.args = args
        self.chunk = chunk
        self._centers: Dict[int, torch.Tensor] = {}   # per iteration: init-dependent

    def _center(self, it: int, stack, clsstr: str):
        """The iteration's DSVDD centre under its init (None for objectives
        without one), computed once per iteration."""
        trainer = self.trainer
        if it not in self._centers:
            stack.load_member(trainer.model, 0)
            self._centers[it] = trainer.prepare_metric(
                clsstr, trainer.ds, TrainState(trainer.model, None), it)
        return self._centers[it]

    def evaluate_population(self, individuals: Sequence[Sequence[int]]) -> List[float]:
        """Fitness (the mean test AUROC over the iterations) per individual."""
        trainer = self.trainer
        ds = trainer.ds
        assert isinstance(ds, CombinedDataset)
        cls = self.args.classes[0]
        clsstr = str_labels(trainer.dsstr)[cls]
        oeds = ds.oe.train_set
        valid = np.asarray(getattr(oeds, "valid_indices", oeds.indices))
        train_set, B, device = ds.train_set, trainer.batch_size, trainer.device
        oesize = len(individuals[0])
        rt_stats = trainer._rt_stats(ds)

        Xn = trainer._to_device(train_set.gather_all())
        Ln = trainer._to_device(ds.normal.binary_targets(train_set))
        test_x = [trainer._preprocess(ds, x, lb, None, False, "normal", rt_stats)
                  .to(trainer.compute_dtype) for x, lb in trainer.test_batches(ds)]
        test_labels = ds.normal.binary_targets(ds.test_set)
        keep = torch.from_numpy(np.flatnonzero(test_labels >= 0)).to(device)
        kept_labels = trainer._to_device(test_labels)[keep]

        fitness = np.zeros((len(individuals), self.args.iterations), np.float64)
        for it in range(self.args.iterations):
            seed = _seed(trainer.seed, cls, it, 0)
            sampler = BalancedEpochSampler(len(train_set), oesize, B, _seed(seed, 1))
            epoch_plans = [sampler.epoch() for _ in range(trainer.epochs)]
            plans = [torch.from_numpy(np.stack([a, b, c.astype(np.int64)])).to(device)
                     for a, b, c in epoch_plans]

            def pool(chunk):   # the candidates' OE images, (k, oesize, h, w, c)
                return trainer._to_device(np.stack([oeds.source.gather(
                    valid[np.asarray(list(ind), np.int64) % len(valid)]) for ind in chunk]))

            def probe(k):
                stack = trainer.init_states_stacked([seed] * k, sampler.steps)
                center = self._center(it, stack, clsstr)
                xo, gen = pool(individuals[:1] * k), torch.Generator(device=device).manual_seed(0)
                c = None if center is None else center.expand(k, *center.shape)
                return probe_steps(trainer, ds, lambda: self._step(
                    stack, plans[0][:, 0], Xn, Ln, xo, gen, c, rt_stats), [gen], stack.optimizer)

            mesh = trainer._dp_mesh()
            per = meshlib.all_reduce_min(
                mesh, members_per_program(trainer, ("candidates", oesize), self.chunk, probe))
            shard = trainer._last_vmap_sharded = meshlib.splits(mesh)
            for start in range(0, len(individuals), per):
                n_chunk = len(individuals[start:start + per])
                lo, hi = meshlib.local_rows(mesh if shard else None, n_chunk)
                chunk = individuals[start + lo:start + hi]
                aucs = torch.zeros(0, device=device)   # a rank's empty share of a short chunk
                if chunk:
                    k = len(chunk)
                    stack = trainer.init_states_stacked([seed] * k, sampler.steps)
                    center = self._center(it, stack, clsstr)
                    center = trainer.center = None if center is None else \
                        center.expand(k, *center.shape)
                    Xo = pool(chunk)
                    # one generator for every candidate: the draws of each
                    # candidate's sequential run are the same
                    generator = torch.Generator(device=device).manual_seed(_seed(seed, 2))
                    if trainer.resident_epoch(ds, stacked=True) and trainer.epochs > 0:
                        self._train_resident(stack, epoch_plans, sampler.steps, Xn, Ln, Xo,
                                             generator, center, rt_stats)
                    else:
                        for plan in plans:
                            for s in range(sampler.steps):
                                self._step(stack, plan[:, s], Xn, Ln, Xo, generator, center,
                                           rt_stats)
                    scores = torch.cat([stack.scores(x, center) for x in test_x], 1)
                    aucs = torch.func.vmap(auroc_torch, in_dims=(None, 0))(
                        kept_labels, scores[:, keep])
                if shard:
                    aucs = meshlib.gather_rows(mesh, aucs, n_chunk)
                fitness[start:start + n_chunk, it] = aucs.cpu().numpy()
        return fitness.mean(axis=1).tolist()

    def _train_resident(self, stack, epoch_plans, steps: int, Xn, Ln, Xo, generator, center,
                        rt_stats):
        """Every (epoch, step) pair of a chunk through
        ``graphs.ResidentSteps``: the plans of every epoch packed on the
        device, each step's row read at a device counter."""
        device = self.trainer.device
        plans = graphs.DevicePlans([graphs.pack_plan(*p) for p in epoch_plans], 1, device)
        cursor = torch.zeros(1, dtype=torch.int64, device=device)

        def step():
            self._step(stack, plans.row(cursor), Xn, Ln, Xo, generator, center, rt_stats)
            cursor.add_(1)

        runner = graphs.ResidentSteps(step, device, graphs.chunk_steps(steps), [generator],
                                      [stack.optimizer])
        try:
            for ep in range(len(epoch_plans)):
                plans.load(ep)
                runner.run(steps)
        finally:
            runner.close()

    def _step(self, stack, plan, Xn, Ln, Xo, generator, center, rt_stats):
        """One update of every candidate: the shared normal half of ``plan``
        ((3, B): normal and OE positions, weights) and each candidate's OE
        half from its pool ``Xo``."""
        trainer, ds = self.trainer, self.trainer.ds
        k, B = Xo.shape[0], plan.shape[1]
        i_n, i_o, w = plan[0], plan[1], plan[2].float()
        ln = Ln.index_select(0, i_n)[None]
        lo = torch.full((k, B), ds.anomalous_label, dtype=Ln.dtype, device=Ln.device)
        xn = preprocess_members(trainer, ds, Xn.index_select(0, i_n)[None], ln, [generator],
                                "normal", rt_stats)
        xo = preprocess_members(trainer, ds, Xo.index_select(1, i_o), lo, [generator] * k, "oe",
                                rt_stats)
        x = torch.cat([xn.expand(k, *xn.shape[1:]), xo], 1)
        labels = torch.cat([ln.expand(k, B), lo], 1)
        weights = torch.cat([w, w]).expand(k, 2 * B) * (labels >= 0)
        stack.step(x.to(trainer.compute_dtype), labels, weights, center)
