"""Seed-vmapped grid training: the seeds of one class train as one program.
The port of eoe_tpu/training/vmapped_seeds.py.

The K members' parameters, batch-norm averages and optimizer state are
stacked on a leading axis (``StackedState``, built by
``Trainer.init_states_stacked``). One step is ``torch.func.vmap`` over
``functional_call`` + ``grad`` of the member's loss, and one optimizer updates
every stacked leaf: Adam and SGD with Nesterov momentum are elementwise, so
each member gets its own update. Batch norm returns its new averages from
the step (``models.layers.collect_averages``), so every member keeps its own;
the fused-QKV and flash kernels take the members in their image axis, the
fused stem keeps each member's statistics.

Each member draws what its sequential run draws: the sampler's plans from
``_seed(seed, 1)`` and the augmentations from a ``torch.Generator`` of
``_seed(seed, 2)``. The augmentations work on each image alone, so each
member draws for its own batch (``fn.draw``) and the pipeline runs once over
the members' batches folded into one. The data are shared and resident; the
index plans of every member move to the device once per epoch, and the last
epoch's scores, labels and weights, with every step's losses, come back once
at the end.

Where ``trainer.resident_epoch`` holds (the card, or ``EOE_TPU_CPU_SCAN=1``),
the epochs take the resident path of ``training.graphs``, as
the JAX package scans them: every epoch's plans of every member move to the
device packed as int32 once, and each step reads its row at a device
counter, writes the members' losses and the epoch's outputs into static
buffers, and is replayed from captured CUDA graphs with every member's
generator registered.

``EOE_TPU_TIMING=1`` prints the host-side phases of a vmapped class (init,
centres, upload, steps), as in the JAX package. Under a data mesh a program
is split over the ranks (``train_cls_vmapped_seeds``' ``mesh``): each rank
trains its ``local_rows`` of the members with no collective, an uneven
share where the data size does not divide them (3 seeds on 2 ranks train 2
+ 1) and none on some ranks where they are fewer than the ranks, and the
per-member results are gathered in seed order over the ranks before they
are logged. A member's numbers are one process's: it draws from its own
generators. The JAX package shards the seeds where the data size divides
them and otherwise splits each member's batch over the devices, which a
collective inside ``torch.func.vmap`` cannot do and no seed needs. Under a
model axis neither package shards the seeds: every rank runs every seed on
the whole model (``self.model``, never the trainer's sharded copy). A rank's
stacked program holds no collective, so it takes the resident path under
any mesh (``trainer.resident_epoch(ds, stacked=True)``), gloo ranks sharing
a card included.
"""

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from eoe_tpu_torch.datasets.bases import BalancedEpochSampler, CombinedDataset
from eoe_tpu_torch.models.layers import collect_averages
from eoe_tpu_torch.ops import metrics as M
from eoe_tpu_torch.parallel import mesh as meshlib
from eoe_tpu_torch.training import graphs
from eoe_tpu_torch.training.optim import ScheduledOptimizer


def upload_packed(tensors: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """CPU tensors to ``device`` in one copy per dtype: packed into one flat
    buffer, moved, and split into views of the original shapes."""
    out = {}
    for dtype in {t.dtype for t in tensors.values()}:
        names = [n for n, t in tensors.items() if t.dtype == dtype]
        flat = torch.cat([tensors[n].reshape(-1) for n in names]).to(device)
        for n, part in zip(names, flat.split([tensors[n].numel() for n in names])):
            out[n] = part.view(tensors[n].shape)
    return {n: out[n] for n in tensors}


class StackedState:
    """K members of one model: every entry of its ``state_dict`` stacked on a
    leading axis on the device (``tensors``), the trainable ones leaf
    parameters under one ``optimizer``. ``model`` is the module the members
    run through (``functional_call``; its own weights are not used),
    ``objective`` and ``loss_kwargs`` the trainer's."""

    def __init__(self, model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                 trainable: Sequence[str], optimizer: ScheduledOptimizer, objective,
                 loss_kwargs):
        self.model, self.tensors, self.optimizer = model, tensors, optimizer
        self.n = next(iter(tensors.values())).shape[0]
        self.trainable = list(trainable)
        self.objective, self.loss_kwargs = objective, loss_kwargs
        self._layer_names = {m: name for name, m in model.named_modules()}
        self._grad = grad(self._member_loss, has_aux=True)

    # ------------------------------------------------------------- steps

    def _member_loss(self, train, rest, x, labels, weights, center):
        with collect_averages() as collected:
            feats = functional_call(self.model, {**train, **rest}, (x,)).float()
        kw = self.loss_kwargs(x)
        loss = self.objective.loss(feats, labels, center, weights=weights, **kw)
        scores = self.objective.score(feats.detach(), center, **kw).reshape(-1)
        averages = {f"{self._layer_names[m]}.{buf}": v for m, pair in collected.items()
                    for buf, v in zip(("running_mean", "running_var"), pair)}
        return loss, (loss.detach(), scores, averages)

    def grads(self, x: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
              center: Optional[torch.Tensor]):
        """Every member's gradients, losses, scores and new BN averages on its
        batch, in train mode, without an update: ``x`` (K, N, ...) in the
        compute dtype, ``labels`` and ``weights`` (K, N), ``center`` (K, ...)
        or None."""
        self.model.train()
        train = {n: self.tensors[n].detach() for n in self.trainable}
        rest = {n: t.detach() for n, t in self.tensors.items() if n not in train}
        grads, (loss, scores, averages) = vmap(
            self._grad, in_dims=(0, 0, 0, 0, 0, None if center is None else 0))(
            train, rest, x, labels, weights, center)
        return grads, loss, scores, averages

    def step(self, x: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
             center: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update of every member on its batch (the arguments of
        ``grads``). Returns the device tensors (losses (K,), scores (K, N))."""
        grads, loss, scores, averages = self.grads(x, labels, weights, center)
        for n in self.trainable:
            self.tensors[n].grad = grads[n]
        self.optimizer.step()
        self.optimizer.zero_grad()
        with torch.no_grad():
            for n, v in averages.items():
                self.tensors[n].copy_(v)
        return loss, scores

    @torch.no_grad()
    def scores(self, x: torch.Tensor, center: Optional[torch.Tensor]) -> torch.Tensor:
        """Every member's anomaly scores of one shared batch ``x`` (in the
        compute dtype), in eval mode: (K, N)."""
        model = self.model.eval()
        kw = self.loss_kwargs(x)

        def member_scores(tensors, c):
            with collect_averages():
                feats = functional_call(model, tensors, (x,)).float()
            return self.objective.score(feats, c, **kw).reshape(-1)

        tensors = {n: t.detach() for n, t in self.tensors.items()}
        return vmap(member_scores, in_dims=(0, None if center is None else 0))(tensors, center)

    # ------------------------------------------------------------- members

    @torch.no_grad()
    def load_member(self, model: torch.nn.Module, k: int):
        """Copy member ``k``'s weights and averages into ``model``."""
        model.load_state_dict({n: t[k] for n, t in self.tensors.items()})

    def host_members(self) -> List[Tuple[dict, dict]]:
        """Every member's (state dict, optimizer state dict) on the CPU, in
        the formats of the sequential ``TrainState``'s model and optimizer,
        from one download of each stacked tensor."""
        tensors = {n: t.detach().cpu() for n, t in self.tensors.items()}
        opt = self.optimizer.state_dict()
        state = {i: {key: v.cpu() if torch.is_tensor(v) else v for key, v in s.items()}
                 for i, s in opt["optimizer"]["state"].items()}
        out = []
        for k in range(self.n):
            member_state = {i: {key: v[k] if torch.is_tensor(v) and v.dim() > 0 else v
                                for key, v in s.items()} for i, s in state.items()}
            out.append(({n: t[k].clone() for n, t in tensors.items()},
                        {"optimizer": {"state": member_state,
                                       "param_groups": opt["optimizer"]["param_groups"]},
                         "count": opt["count"]}))
        return out


# ---------------------------------------------------------------- draws


def member_draws(fn, sample: torch.Tensor, rt_stats,
                 generators: Sequence[torch.Generator]) -> List[Dict[str, torch.Tensor]]:
    """The draws of pipeline ``fn`` for every member's batch of the shape of
    ``sample``, each member from its own generator, concatenated in member
    order (the folded batch's order). A generator listed K times draws once
    and its draws repeat."""
    per, seen = [], {}
    for g in generators:
        if id(g) not in seen:
            seen[id(g)] = fn.draw(sample, rt_stats, generator=g)
        per.append(seen[id(g)])
    return [{key: torch.cat([d[i][key] for d in per]) for key in per[0][i]}
            for i in range(len(per[0]))]


def preprocess_members(trainer, ds, x: torch.Tensor, labels: torch.Tensor,
                       generators: Sequence[torch.Generator], part: str, rt_stats
                       ) -> torch.Tensor:
    """Train-mode (conditional ->) pipeline of one half-batch of every
    member: ``x`` (K, B, h, w, c) raw images, ``labels`` (K, B); member k
    draws from ``generators[k]`` exactly what its sequential step draws."""
    sub = (ds.oe if part == "oe" else ds.normal) if isinstance(ds, CombinedDataset) else ds
    cond, pipe = sub.train_conditional_pipeline, sub.train_pipeline
    K, B = x.shape[:2]
    flat, flat_labels = x.reshape(K * B, *x.shape[2:]), labels.reshape(-1)
    flat = cond(flat, flat_labels, rt_stats,
                draws=member_draws(cond, x[0], rt_stats, generators))
    flat = pipe(flat, rt_stats, draws=member_draws(pipe, flat[:B], rt_stats, generators))
    return flat.reshape(K, B, *flat.shape[1:])


def stacked_step(trainer, ds, stack: StackedState, xn, ln, xo, lo, w, generators,
                 center, rt_stats):
    """One update of every member on its normal half (+ OE half), the
    counterpart of ``Trainer.train_step``: each argument carries the member
    axis first. Returns the device tensors (losses, scores, labels, weights)."""
    xn = preprocess_members(trainer, ds, xn, ln, generators, "normal", rt_stats)
    if xo is not None:
        xo = preprocess_members(trainer, ds, xo, lo, generators, "oe", rt_stats)
        x, labels, weights = torch.cat([xn, xo], 1), torch.cat([ln, lo], 1), torch.cat([w, w], 1)
    else:
        x, labels, weights = xn, ln, w
    weights = weights * (labels >= 0)
    loss, scores = stack.step(x.to(trainer.compute_dtype), labels, weights, center)
    return loss, scores, labels, weights


# ---------------------------------------------------------------- engine


def train_cls_vmapped_seeds(trainer, ds, cls: int, clsstr: str, n_seeds: int,
                            seeds: Sequence[int], first: int = 0,
                            mesh: Optional[meshlib.Mesh] = None
                            ) -> Tuple[Optional[StackedState], List[Optional[M.ROC]]]:
    """Train ``n_seeds`` members of class ``cls`` at once, member k from seed
    ``seeds[k]`` as ``Trainer.train_cls`` trains that seed: its init, its
    sampler, its augmentation draws and its DSVDD centre. Member k logs as
    seed ``first + k`` (the seeds of a class may train in several programs);
    the first program writes the class's preview. Returns the stacked state
    and each member's train ROC of the last epoch (None without anomalous
    samples). Raises ``NanGradientsError`` when a member's scores turned
    NaN. With ``mesh`` the program is split over the data ranks: this rank
    trains its ``local_rows`` of the members (an uneven share, or none: its
    state is then None), with no collective in a step; the members' losses,
    scores, labels and weights are gathered in member order before anything
    is logged, so that every rank logs and returns what one process does and
    the NaN verdict is theirs together."""
    from eoe_tpu_torch.training.trainer import NanGradientsError

    assert len(seeds) == n_seeds
    if first == 0:
        trainer.write_train_preview(ds, cls, clsstr)
    lo, hi = meshlib.local_rows(mesh, n_seeds)
    stack, packed, steps, t0 = _train_members(trainer, ds, clsstr, seeds[lo:hi], first + lo)
    if trainer.epochs == 0:
        return stack, [None] * n_seeds
    packed = meshlib.gather_rows(mesh, packed, n_seeds).cpu().numpy()
    dt = time.time() - t0
    n_loss = trainer.epochs * steps
    n_last = (packed.shape[1] - n_loss) // 3
    ep_losses = packed[:, :n_loss]
    scores, labels, weights = (packed[:, n_loss + i * n_last:n_loss + (i + 1) * n_last]
                               for i in range(3))
    for k in range(n_seeds):
        trainer.step_losses.extend(map(float, ep_losses[k]))
    n_imgs = int(weights.sum()) * trainer.epochs
    trainer.epoch_rates.append(n_imgs / max(dt, 1e-9))
    ep = trainer.epochs - 1
    rocs = [None] * n_seeds
    for k, it in enumerate(range(first, first + n_seeds)):
        keep = weights[k] > 0
        sc, lb = scores[k][keep], labels[k][keep]
        if np.isnan(sc).any():
            raise NanGradientsError()
        trainer.logger.hist(f"Training: CLS{cls} SEED{it} anomaly_scores normal", sc[lb == 0], ep)
        if (lb == 1).sum() > 0:
            trainer.logger.hist(f"Training: CLS{cls} SEED{it} anomaly_scores anomalous",
                                sc[lb == 1], ep)
            rocs[k] = M.roc_curve(lb.astype(np.int64), sc)
            trainer.logger.add_scalar(f"Training: CLS{cls} SEED{it} AUC", rocs[k].auc * 100, ep)
        for e in range(trainer.epochs):   # every epoch's loss, the last one's AUC
            loss = float(ep_losses[k, e * steps:(e + 1) * steps].mean())
            trainer.logger.add_scalar(f"training_cls{cls}_seed{it}_loss", loss, e)
            trainer.logger.print(
                f"cls {cls} seed {it} epoch {e + 1}/{trainer.epochs}: loss {loss:.5f}"
                + (f", train AUC {rocs[k].auc * 100:.2f}%"
                   if rocs[k] is not None and e == ep else ""))
    trainer.logger.print(f"cls {cls}: {n_seeds} seeds x {trainer.epochs} epochs in {dt:.2f} s, "
                         f"{n_imgs / max(dt, 1e-9):.0f} img/s")
    return stack, rocs


def _train_members(trainer, ds, clsstr: str, seeds: Sequence[int], first: int):
    """Train a stack of one member per seed of ``seeds`` (member k the seed
    of index ``first + k``), with no collective. Returns (the stacked state,
    the device tensor (K, every step's loss, then the last epoch's scores,
    labels and weights), steps an epoch, the time the steps began); with no
    seeds (a rank's empty share) no state and (0, ...) rows."""
    from eoe_tpu_torch.training.trainer import TrainState, _seed

    timing = os.environ.get("EOE_TPU_TIMING") == "1"

    def phase(tag, t0):
        if timing:
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            print(f"    [vmap-seeds] {tag}: {time.time() - t0:.2f}s", flush=True)
        return time.time()

    t = time.time()
    combined = isinstance(ds, CombinedDataset)
    train_set = ds.train_set
    normal_ds = ds.normal if combined else ds
    oe_set = ds.oe.train_set if combined else None
    has_oe = combined and len(oe_set) > 0
    B, device, K = trainer.batch_size, trainer.device, len(seeds)
    steps = BalancedEpochSampler(len(train_set), len(oe_set) if has_oe else 0, B, 0).steps
    if K == 0:
        width = trainer.epochs * steps + 3 * steps * (2 if has_oe else 1) * B
        return None, torch.zeros(0, width, device=device), steps, time.time()
    samplers = [BalancedEpochSampler(len(train_set), len(oe_set) if has_oe else 0, B,
                                     _seed(s, 1)) for s in seeds]
    stack = trainer.init_states_stacked(seeds, steps)
    t = phase(f"init_states_stacked x{K}", t)

    # every member's centre under its own initial weights (DSVDD; CLIP's
    # prompt centre is the same for every member)
    centers = []
    for k in range(K):
        stack.load_member(trainer.model, k)
        centers.append(trainer.prepare_metric(clsstr, ds, TrainState(trainer.model, None),
                                              first + k))
    center = trainer.center = torch.stack(centers) if centers[0] is not None else None
    rt_stats = trainer._rt_stats(ds)
    t = phase("prepare_metric", t)

    Xn = trainer._to_device(train_set.gather_all())
    Ln = trainer._to_device(normal_ds.binary_targets(train_set))
    Xo = trainer._to_device(oe_set.gather_all()) if has_oe else None
    Lo = trainer._to_device(ds.oe.binary_targets(oe_set)) if has_oe else None
    generators = [torch.Generator(device=device).manual_seed(_seed(s, 2)) for s in seeds]
    t = phase("data upload", t)

    if trainer.epochs == 0:
        return stack, None, steps, t
    halves = (Xn, Ln, Xo, Lo)
    run = _epochs_resident if trainer.resident_epoch(ds, stacked=True) else _epochs_per_step
    packed = run(trainer, ds, stack, samplers, halves, generators, center, rt_stats)
    phase(f"steps x{trainer.epochs * steps}", t)
    return stack, packed, steps, t



def _epochs_per_step(trainer, ds, stack: StackedState, samplers, halves, generators, center,
                     rt_stats) -> torch.Tensor:
    """Every epoch as a loop of eager stacked steps, each epoch's plans
    moved to the device in one upload. Returns the device tensor (K, every
    step's loss, then the last epoch's scores, labels and weights)."""
    Xn, Ln, Xo, Lo = halves
    losses, last = [], None
    for ep in range(trainer.epochs):
        plans = [s.epoch() for s in samplers]
        plan = torch.from_numpy(np.stack([
            np.stack([p[0] for p in plans]),
            np.stack([p[1] if Xo is not None else np.zeros_like(p[0]) for p in plans]),
            np.stack([p[2] for p in plans]).astype(np.int64)])).to(trainer.device)
        outs = []
        for s in range(samplers[0].steps):
            i_n, i_o, w = plan[0, :, s], plan[1, :, s], plan[2, :, s].float()
            xo, lo = (Xo[i_o], Lo[i_o]) if Xo is not None else (None, None)
            outs.append(stacked_step(trainer, ds, stack, Xn[i_n], Ln[i_n], xo, lo, w,
                                     generators, center, rt_stats))
        losses.extend(o[0] for o in outs)
        last = outs
    return torch.cat([torch.stack(losses, 1)] + [torch.cat([o[i] for o in last], 1).float()
                                                 for i in (1, 2, 3)], 1)


def _epochs_resident(trainer, ds, stack: StackedState, samplers, halves, generators, center,
                     rt_stats) -> torch.Tensor:
    """Every epoch through ``graphs.ResidentSteps``: the members' plans of
    every epoch packed on the device ((3, K, steps, B) an epoch), a step
    counter there, the losses of every step and the outputs of the epoch's
    steps written into static buffers. Returns what ``_epochs_per_step``
    returns."""
    Xn, Ln, Xo, Lo = halves
    K, B, device, steps = stack.n, trainer.batch_size, trainer.device, samplers[0].steps
    E = trainer.epochs
    plans = []
    for _ in range(E):
        ps = [s.epoch() for s in samplers]
        plans.append(graphs.pack_plan(np.stack([p[0] for p in ps]), np.stack(
            [p[1] for p in ps]) if Xo is not None else None, np.stack([p[2] for p in ps])))
    plans = graphs.DevicePlans(plans, 2, device)
    L = (2 if Xo is not None else 1) * B
    losses = torch.zeros(E * steps, K, device=device)
    last = torch.zeros(steps, 3, K, L, device=device)
    cursor = torch.zeros(1, dtype=torch.int64, device=device)

    def gather(X, Lb, idx):
        flat = idx.reshape(-1)
        return (X.index_select(0, flat).reshape(K, B, *X.shape[1:]),
                Lb.index_select(0, flat).reshape(K, B))

    def step():
        i_n, i_o, w = plans.row(cursor)
        xn, ln = gather(Xn, Ln, i_n)
        xo, lo = gather(Xo, Lo, i_o) if Xo is not None else (None, None)
        loss, scores, labels, weights = stacked_step(trainer, ds, stack, xn, ln, xo, lo,
                                                     w.float(), generators, center, rt_stats)
        losses.index_copy_(0, cursor, loss.float()[None])
        last.index_copy_(0, cursor % steps, torch.stack(
            [scores.float(), labels.float(), weights.float()])[None])
        cursor.add_(1)

    runner = graphs.ResidentSteps(step, device, graphs.chunk_steps(steps), generators,
                                  [stack.optimizer])
    try:
        for ep in range(E):
            plans.load(ep)
            runner.run(steps)
    finally:
        runner.close()
    return torch.cat([losses.t()] + list(last.permute(1, 2, 0, 3).reshape(3, K, -1)), 1)


def eval_scores_vmapped(trainer, ds, states: Optional[StackedState], n_seeds: int
                        ) -> np.ndarray:
    """Every member's anomaly scores of the test split, (n_seeds, n_test):
    shared batches as ``Trainer.eval_scores`` builds them, each through the
    test pipeline once and every member's model, one download at the end;
    (0, n_test) without a state (a rank's empty share of a program)."""
    if states is None:
        return np.zeros((0, len(ds.test_set)), np.float32)
    assert states.n == n_seeds
    rt_stats = trainer._rt_stats(ds)
    outs = [states.scores(trainer._preprocess(ds, x, lb, None, False, "normal", rt_stats)
                          .to(trainer.compute_dtype), trainer.center)
            for x, lb in trainer.test_batches(ds)]
    return torch.cat(outs, 1).cpu().numpy()[:, :len(ds.test_set)]


# ---------------------------------------------------------------- memory


def members_that_fit(peaks: Tuple[int, int], free: int, wanted: int) -> int:
    """How many members one program holds, at most ``wanted`` and at least
    1: ``peaks`` are the bytes that one step of a fresh stack of one and of
    two members took (weights, optimizer state, gradients, activations),
    ``free`` the bytes the card can still give. A member costs the
    difference of the peaks, the rest of the first peak is fixed; a tenth of
    ``free`` stays spare for the allocator's fragmentation."""
    per_member = max(peaks[1] - peaks[0], 1)
    fixed = max(peaks[0] - per_member, 0)
    return max(1, min(wanted, int((0.9 * free - fixed) // per_member)))


def members_per_program(trainer, key, wanted: int, probe: Callable[[int], object]) -> int:
    """``members_that_fit`` on the trainer's card. ``probe(k)`` runs one step
    of a fresh stack of k members at the run's shapes, as the program runs
    it: on the resident path a step, its capture and a replay
    (``probe_steps``), returning the runner, whose graph still holds its
    private memory pool. Its peaks above what was allocated before it
    (``torch.cuda.max_memory_allocated``, whose statistic this resets), or
    the memory that a live graph keeps reserved with the stack (after
    ``empty_cache``) where that is more, are measured once per ``key`` and
    kept in ``trainer.member_peaks``; the free memory is read at every
    call. When the step of two members runs out of memory, 1 (an
    out-of-memory error in a capture ends the capture first). Off the card,
    ``wanted``."""
    device = trainer.device
    if device.type != "cuda" or wanted < 2:
        return wanted
    if key not in trainer.member_peaks:
        peaks = []
        for k in (1, 2):
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
            base_reserved = torch.cuda.memory_reserved(device)
            torch.cuda.reset_peak_memory_stats(device)
            try:
                runner = probe(k)
            except torch.cuda.OutOfMemoryError:
                peaks = [0, 1 << 62]   # no second member fits
                break
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - base
            if runner is not None:   # the graph's pool is reserved, not allocated
                torch.cuda.empty_cache()
                peak = max(peak, torch.cuda.memory_reserved(device) - base_reserved)
                runner.close()
                del runner
            peaks.append(peak)
        torch.cuda.empty_cache()
        trainer.member_peaks[key] = tuple(peaks)
    free = (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return members_that_fit(trainer.member_peaks[key], free, wanted)


def probe_steps(trainer, ds, step: Callable[[], object], generators, optimizer):
    """A memory probe's step as its program runs it: on the resident path
    an eager step, a captured one-step graph and its replay (the runner is
    returned, its graph alive); else one eager step (None)."""
    if not trainer.resident_epoch(ds, stacked=True):
        step()
        return None
    runner = graphs.ResidentSteps(step, trainer.device, 1, generators, [optimizer])
    try:
        runner.run(2)
    except BaseException:
        runner.close()
        raise
    return runner


def seeds_per_program(trainer, ds, clsstr: str, seeds: Sequence[int]) -> int:
    """How many of ``seeds`` one program of ``train_cls_vmapped_seeds``
    holds (``members_per_program``). The probe trains fresh stacks of the
    first seed one step on the first images of each split, with that seed's
    centre and a throwaway generator."""
    from eoe_tpu_torch.training.trainer import TrainState

    combined = isinstance(ds, CombinedDataset)
    train_set, normal_ds = ds.train_set, (ds.normal if combined else ds)
    oe_set = ds.oe.train_set if combined else None
    has_oe = combined and len(oe_set) > 0
    B, device = trainer.batch_size, trainer.device
    steps = BalancedEpochSampler(len(train_set), len(oe_set) if has_oe else 0, B, 0).steps
    center = {}

    def half(subset, labels, k):
        idx = np.arange(B) % len(subset)
        x, lb = trainer._to_device(subset.gather(idx)), trainer._to_device(labels[idx])
        return x.expand(k, *x.shape), lb.expand(k, B)

    def probe(k):
        stack = trainer.init_states_stacked([seeds[0]] * k, steps)
        if not center:
            stack.load_member(trainer.model, 0)
            center[0] = trainer.prepare_metric(clsstr, ds, TrainState(trainer.model, None), 0)
        c = None if center[0] is None else center[0].expand(k, *center[0].shape)
        xn, ln = half(train_set, normal_ds.binary_targets(train_set), k)
        xo, lo = half(oe_set, ds.oe.binary_targets(oe_set), k) if has_oe else (None, None)
        gen = torch.Generator(device=device).manual_seed(0)
        w, rt = torch.ones(k, B, device=device), trainer._rt_stats(ds)
        return probe_steps(trainer, ds, lambda: stacked_step(
            trainer, ds, stack, xn, ln, xo, lo, w, [gen] * k, c, rt), [gen], stack.optimizer)

    key = ("seeds", tuple(train_set.gather(np.arange(1)).shape[1:]), has_oe and
           tuple(oe_set.gather(np.arange(1)).shape[1:]))
    return members_per_program(trainer, key, len(seeds), probe)
