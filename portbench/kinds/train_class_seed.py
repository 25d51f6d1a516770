"""The kind ``train_class_seed``: one class-seed of an EOE run through
``Trainer.train_cls`` on the resident epoch, the trainer's normal path.

The mix's parameters: ``n_normal`` raw images of the normal class and
``n_oe`` OE images, square (``raw_size``), uint8, ``channels``; the class
is drawn from the seed among ``classes``. The normal class and the OE set
take image ranges of their own (``content`` and ``oe_content``), as a class
and its outliers differ.

Set-up is everything up to the end of the class-seed's first epoch: the
process, the program's imports and kernel builds, the weights and images
made from the seed, the trainer (the configuration's hyperparameters), the
class-seed's own set-up (weights copied in, optimizer, plans, the objective's
centre, the first eager step and the CUDA-graph capture) and the rest of that
epoch. The window holds the following whole epochs, with their per-epoch
download and log: it ends at the first epoch boundary after ``--seconds``,
or with the class-seed. Where the learning-rate schedule moves inside the
window, the trainer captures its step anew there, as it does in every run.

``Probe`` watches the timed path through the program's public names (the
dataset's ``train_pipeline``, the trainer's ``init_state`` and
``make_train_epoch_resident``, the plans' ``load``, the optimizer's ``step``
and ``rates``) without changing what it computes. Epochs end where the
trainer loads the next epoch's plan. It records:

* the first ``STEPS`` steps of the class-seed: their augmentation draws
  (the pipelines draw, then apply those draws, as ``draw`` and ``draws=``
  make the same calls), plan rows and outputs, the optimizer's state after
  the first step and the parameters after ``STEPS`` steps;
* steps of the window itself: the first step of the window (the first of
  epoch 1) and the first step after the schedule moves inside the window
  (the first replay of the graph captured anew): the parameters and the
  optimizer's moments before the step, its moments after (whence the
  gradient the optimizer received), its draws, plan row and outputs.

On the card the steps after the first are graph replays: the draws of a
replay are read from the tensors the capture drew into, held alive, between
replays.
"""

import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check, trace as tracing
from portbench.harness import traffic as gen
from portbench.harness.common import BenchError, family_module, seed_of

ROLE = "train"   # what the per-layer metrics read it as
STEPS = 3        # the first steps the reference follows


def train_inputs(t: dict, seed: int, device) -> dict:
    """{"xn", "xo": uint8 arrays, "cls": the normal class's index}."""
    g = gen.generator(seed, gen.IMAGES, device)
    size, c = t["raw_size"], t["channels"]
    xn = gen.images(t["n_normal"], size, c, t["content"], g, device)
    xo = gen.images(t["n_oe"], size, c, t["oe_content"], g, device)
    cls = int(np.random.default_rng(seed_of(seed, gen.CLASS)).integers(t["classes"]))
    return {"xn": xn, "xo": xo, "cls": cls}


def end_to_end(out: dict, t0: float) -> dict:
    """The end-to-end metrics a run of this kind gives, by name."""
    return {"setup_s": out["setup_end"] - t0,
            "train_img_per_s": out["images"] / out["window_s"]}


def attempted(out: dict) -> int:
    return out["steps"]


class StopWindow(Exception):
    """Raised at the epoch boundary that closes the window."""


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _clone(draws: List[dict]) -> List[dict]:
    return [{k: v.detach().clone() for k, v in d.items()} for d in draws]


class Recorder:
    """Wraps a compiled pipeline: draws with the generator, then applies the
    draws, keeping the first ``keep`` eager draws; ``live`` is the latest
    draws (on the card after a capture, the capture's tensors, which each
    replay draws into), ``prev`` the ones before them."""

    def __init__(self, fn, keep: int):
        self.fn, self.keep = fn, keep
        self.eager: List[List[dict]] = []
        self.live: Optional[List[dict]] = None
        self.prev: Optional[List[dict]] = None
        self.apply = self._wrapped()

    def draw(self, images, rt_stats=None, *, generator):
        """The pipeline's draws; a data mesh's rank draws for the whole
        half-batch this way and applies its rows."""
        draws = self.fn.draw(images, rt_stats, generator=generator)
        self.prev, self.live = self.live, draws
        if not _capturing() and len(self.eager) < self.keep:
            self.eager.append(_clone(draws))
        return draws

    def _wrapped(self):
        def apply(images, rt_stats=None, *, generator=None, draws=None, record=None):
            if generator is not None and draws is None:
                draws = self.draw(images, rt_stats, generator=generator)
            return self.fn(images, rt_stats, draws=draws, record=record)
        for k in ("specs", "random_ops", "fused"):
            if hasattr(self.fn, k):
                setattr(apply, k, getattr(self.fn, k))
        apply.draw = self.draw
        return apply


class _Watched:
    """A dataset whose training pipeline a ``Recorder`` may wrap."""

    recorder: Optional[Recorder] = None

    @property
    def train_pipeline(self):
        return self.recorder.apply if self.recorder is not None else super().train_pipeline


class Probe:
    def __init__(self, trainer, ds, epoch_end, lead: bool = True, steps: int = STEPS):
        """``epoch_end(ep, images, steps)`` is called where epoch ``ep``
        ends and raises ``StopWindow`` to close the window; ``lead``: this
        process reports (window steps are recorded there alone)."""
        self.steps, self.lead, self.trainer = steps, lead, trainer
        self.state = self.plans = self.outputs = self.runner = None
        self.per_epoch = None
        self.replayed: Dict[str, Dict[int, List[dict]]] = {"normal": {}, "oe": {}}
        self.first_gradient: Optional[Dict[str, torch.Tensor]] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.first_outputs: Optional[torch.Tensor] = None
        self.window: List[dict] = []      # the window's steps, recorded whole
        self._pending: Optional[dict] = None
        self._moved = False               # a step after a schedule move was taken
        self.rec = {part: Recorder(getattr(ds, part).train_pipeline, steps)
                    for part in ("normal", "oe")}
        ds.normal.recorder, ds.oe.recorder = self.rec["normal"], self.rec["oe"]
        init_state, make_runner = trainer.init_state, trainer.make_train_epoch_resident
        seen = [0]

        def init_state_probe(*a, **k):
            state = init_state(*a, **k)
            self._attach(state)
            return state

        def make_runner_probe(state, ds_, halves, plans, steps_, *a, **k):
            self.plans, self.per_epoch = plans, steps_
            runner, out = make_runner(state, ds_, halves, plans, steps_, *a, **k)
            self.runner, self.outputs = runner, out
            load = plans.load

            def load_probe(epoch: int):
                if epoch > 0:
                    images = trainer.images_seen - seen[0]
                    seen[0] = trainer.images_seen
                    epoch_end(epoch - 1, images, steps_)
                load(epoch)

            plans.load = load_probe
            seen[0] = trainer.images_seen
            return runner, out

        trainer.init_state = init_state_probe
        trainer.make_train_epoch_resident = make_runner_probe
        self._seen = seen

    def images_since_last_epoch(self) -> int:
        return self.trainer.images_seen - self._seen[0]

    def _attach(self, state):
        self.state = state
        opt = state.optimizer
        step, rates = opt.step, opt.rates

        def step_probe():   # inside an uncaptured step, after its draws
            if not _capturing():
                self._before_update(opt.count, True)
            step()

        def rates_probe(n):   # before a replay
            self._before_update(opt.count, False)
            return rates(n)

        opt.step, opt.rates = step_probe, rates_probe

    def _trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.state.model.named_parameters() if p.requires_grad}

    def _moments(self) -> Dict[str, torch.Tensor]:
        """The optimizer's first moment of each trainable leaf (zeros where
        no update made one: no gradient arrived)."""
        inner = self.state.optimizer.optimizer
        by_id = {id(p): n for n, p in self._trainable().items()}
        out = {}
        for p in inner.param_groups[0]["params"]:
            st = inner.state[p]
            m = st.get("momentum_buffer", st.get("exp_avg"))
            out[by_id[id(p)]] = m.detach().clone() if m is not None else torch.zeros_like(p)
        return out

    def _received(self, before: Optional[Dict[str, torch.Tensor]],
                  after: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer received in one update, from its first
        moment before and after it: SGD's ``buf = mu buf + d``, Adam's
        ``m = b1 m + (1 - b1) d``."""
        group = self.state.optimizer.optimizer.param_groups[0]
        if "betas" in group:
            b1 = group["betas"][0]
            return {n: (m - (b1 * before[n] if before else 0)) / (1 - b1)
                    for n, m in after.items()}
        mu = group["momentum"]
        return {n: m - mu * before[n] if before else m for n, m in after.items()}

    def _row(self, update: int) -> torch.Tensor:
        """The outputs of the step after ``update`` updates: [loss share,
        scores, labels, weights] of this process's rows."""
        return self.outputs[update % self.per_epoch].detach().clone()

    def _before_update(self, done: int, in_step: bool):
        """Called with the number of updates done, before the next one:
        inside the next step, after it drew (``in_step``), or before it."""
        last = {part: rec.prev if in_step else rec.live for part, rec in self.rec.items()}
        for part in self.rec:
            if last[part] is not None and 1 < done <= self.steps \
                    and done not in self.replayed[part]:
                self.replayed[part][done] = _clone(last[part])
        if done == 1 and self.first_gradient is None:
            self.first_gradient = self._received(None, self._moments())
        if done == self.steps and self.params is None:
            self.params = {n: p.detach().clone() for n, p in self._trainable().items()}
            self.first_outputs = torch.stack([self._row(k) for k in range(self.steps)])
        if not self.lead or self.per_epoch is None:
            return
        if self._pending is not None and done == self._pending["update"] + 1:
            p = self._pending
            self._pending = None
            self.window.append({
                "update": p["update"], "params": p["params"],
                "gradient": self._received(p["moments"], self._moments()),
                "draws": {part: _clone(d) for part, d in last.items()},
                "plan": self.plans.tensor[:, p["update"] % self.plans.rows].long().cpu(),
                "outputs": self._row(p["update"])})
        elif self._pending is None and self._window_step(done):
            self._pending = {"update": done, "moments": self._moments(),
                             "params": {n: p.detach().float().clone()
                                        for n, p in self._trainable().items()}}

    def _window_step(self, done: int) -> bool:
        """Whether the step after ``done`` updates is one the check follows:
        the window's first, or the first where the schedule has moved."""
        if done == self.per_epoch:
            return True
        schedule = self.state.optimizer.schedule
        if done > self.per_epoch and not self._moved and schedule(done) != schedule(done - 1):
            self._moved = True
            return True
        return False

    def draws(self, part: str, step: int) -> List[dict]:
        """The draws of 1-based ``step`` for one half."""
        eager = self.rec[part].eager
        if step <= len(eager):
            return eager[step - 1]
        if step not in self.replayed[part]:
            raise BenchError(f"the draws of step {step} ({part}) were not seen")
        return self.replayed[part][step]

    def plan_rows(self) -> torch.Tensor:
        """(steps, 3, batch) int64: normal positions, OE positions, weights."""
        assert self.plans.axis == 1
        return self.plans.tensor[:, :self.steps].transpose(0, 1).long().cpu()


class EpochClock:
    """Closes the set-up at the end of the first epoch and the window at the
    first epoch boundary after ``seconds``; in a traced run, traces
    ``trace_epochs`` whole epochs after one untraced window epoch."""

    def __init__(self, seconds: float, trace_epochs: Optional[int]):
        self.seconds, self.trace_epochs = seconds, trace_epochs
        self.setup_end = self.start = self.end = None
        self.images = self.steps = 0
        self.epoch_images: List[int] = []
        self.profiler = None
        self.traced = None     # (window_s, images, steps) of the traced epochs

    def epoch_end(self, ep: int, n_images: int, n_steps: int, last: bool, lead: bool) -> bool:
        """Whether the window closes at this boundary (decided by the lead
        rank; a traced run's end is the same on every rank)."""
        now = time.perf_counter()
        if ep == 0:
            self.setup_end = self.start = now
            return False
        self.images += n_images
        self.steps += n_steps
        self.epoch_images.append(n_images)
        self.end = now
        if self.trace_epochs is not None:
            if self.profiler is None and len(self.epoch_images) == 1:
                self.profiler = tracing.start()
                self._t0, self._i0, self._s0 = time.perf_counter(), self.images, self.steps
            elif self.profiler is not None and self.traced is None \
                    and len(self.epoch_images) == 1 + self.trace_epochs:
                self.traced = (now - self._t0, self.images - self._i0, self.steps - self._s0)
                tracing.stop(self.profiler)
                return True
            return False
        return lead and now - self.start >= self.seconds and not last


def build_dataset(inputs: dict, specs, cfg: dict, cls: int):
    """The class-seed's normal ‖ OE dataset over the images, as the dataset
    registry builds ImageNet-30 with ImageNet-21k OE: the normal class takes
    the nominal label, the OE set the other, each its own crop guard."""
    from eoe_tpu_torch.datasets.bases import ArraySource, CombinedDataset, GenericADDataset

    tr = cfg["train"]
    raw = inputs["xn"].shape[1:]

    class Normal(_Watched, GenericADDataset):
        degenerate_crop_guard = tr["guard"]["normal"]

    class OE(_Watched, GenericADDataset):
        degenerate_crop_guard = tr["guard"]["oe"]

    normal = Normal(ArraySource(inputs["xn"], np.full(len(inputs["xn"]), cls)), None, root="",
                    normal_classes=[cls], nominal_label=0, train_specs=specs, test_specs=[],
                    n_classes=tr["classes"], raw_shape=raw)
    oe = OE(ArraySource(inputs["xo"], np.zeros(len(inputs["xo"]), dtype=np.int64)), None, root="",
            normal_classes=[0], nominal_label=1, train_specs=specs, test_specs=[], n_classes=1,
            raw_shape=raw, ds_statistics=normal.ds_statistics)
    return CombinedDataset(normal, oe)


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, chips: int = 1, keep: Optional[dict] = None) -> dict:
    """One run; ``keep``, where given, receives what the check compared
    (``inputs``, ``program``, ``readings``), for the control's tests. On
    several cards this process is rank 0 of a data mesh (NCCL, one card a
    rank) and starts the others (``parallel.mesh.spawn_ranks``); rank 0
    clocks, reports and checks."""
    if chips == 1:
        out, program, inputs = _train(cell, cfg, traffic, seed, seconds, trace, device, None)
    else:
        from eoe_tpu_torch.parallel import mesh as meshlib
        kind = torch.device(device).type
        ranks = meshlib.spawn_ranks(_rank, (cell, cfg, traffic, seed, seconds, trace, chips,
                                            kind), chips)
        try:
            out, program, inputs = _train(cell, cfg, traffic, seed, seconds, trace, None,
                                          _mesh(chips, kind))
        finally:
            meshlib.leave()
            ranks.join()
        device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check.training(cell, cfg, inputs, program, seed, device, keep)
    if keep is not None:
        keep.update(inputs=inputs, program=program)
    return out


def _mesh(chips: int, kind: str):
    from eoe_tpu_torch.parallel import mesh as meshlib
    return meshlib.make_mesh(meshlib.MeshConfig(data=chips, model=1), kind)


def _rank(cell, cfg, traffic, seed, seconds, trace, chips, kind):
    """A rank that ``spawn_ranks`` started: the same class-seed on its card."""
    _train(cell, cfg, traffic, seed, seconds, trace, None, _mesh(chips, kind))


def _stop_together(mesh, stop: bool) -> bool:
    """Rank 0's verdict on every rank, over the host group."""
    if mesh is None:
        return stop
    import torch.distributed as dist
    flag = torch.tensor([int(stop)])
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _train(cell, cfg, traffic, seed, seconds, trace, device, mesh):
    """The class-seed on ``device``, or as this rank of ``mesh``. Returns the
    run's numbers, what the check takes of the program and the inputs (on
    rank 0; the other ranks return after the collective end)."""
    from portbench.harness import weights as wgen

    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    fam = family_module(cfg["family"])
    inputs = train_inputs(traffic, seed, device)
    weights = wgen.make(fam.reference.param_specs(cfg), seed, device)
    trainer = fam.build_trainer(cfg, weights, device, mesh)
    del weights
    ds = build_dataset(inputs, trainer.train_specs, cfg, inputs["cls"])
    clock = EpochClock(seconds, cell["trace_epochs"] if trace else None)
    last_epoch = cfg["train"]["epochs"] - 1

    def epoch_end(ep: int, images: int, steps: int):
        stop = clock.epoch_end(ep, images, steps, ep == last_epoch, lead)
        if ep > 0 and clock.trace_epochs is None:
            stop = _stop_together(mesh, stop)
        if stop:
            raise StopWindow()

    probe = Probe(trainer, ds, epoch_end, lead)
    clsstr = fam.class_label(cfg, cfg["train"]["dataset"], inputs["cls"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        trainer.train_cls(ds, inputs["cls"], clsstr, 0, int(seed) % (2 ** 63))
        # the class-seed ended inside the window: its last epoch closes it
        clock.epoch_end(last_epoch, probe.images_since_last_epoch(), probe.per_epoch, True,
                        lead)
    except StopWindow:
        pass
    if clock.setup_end is None or not trainer.resident_epoch(ds):
        raise BenchError("the class-seed did not train on the resident epoch")
    if cuda:
        torch.cuda.synchronize()
    mine = {"peak": torch.cuda.max_memory_allocated() if cuda else 0}
    if trace:
        mine["trace"] = tracing.read(clock.profiler, *clock.traced)
    ranks = [mine]
    if mesh is not None:
        import torch.distributed as dist
        ranks = [None] * mesh.size
        dist.all_gather_object(ranks, {**mine, "trace": {k: v for k, v in mine.get(
            "trace", {}).items() if k in ("busy_s", "nccl_s")}})
    if not lead:
        return None, None, None
    out = {"window_s": clock.end - clock.start if clock.end is not None else float("nan"),
           "images": clock.images, "steps": clock.steps, "setup_end": clock.setup_end,
           "peak": max(r["peak"] for r in ranks), "epochs": len(clock.epoch_images),
           "captures": [probe.runner.captures, list(probe.runner.capture_seconds)]}
    # the host's seconds of the class-seed's graph captures (making room, recording,
    # instantiating), the window's re-captures among them
    print(f"graph captures: {out['captures'][0]}, seconds {out['captures'][1]!r}",
          file=sys.stderr)
    if trace:
        out["trace"] = mine["trace"]
        out["trace"]["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(ranks)
    losses = trainer.step_losses
    program = {"first_gradient": probe.first_gradient, "params": probe.params,
               "outputs": probe.first_outputs.cpu(),
               "centre": None if trainer.center is None else trainer.center.detach().float(),
               "plans": probe.plan_rows(), "losses": list(losses[:STEPS]),
               "draws": {part: [probe.draws(part, k) for k in range(1, STEPS + 1)]
                         for part in ("normal", "oe")},
               "window": [{**w, "loss": losses[w["update"]], "outputs": w["outputs"].cpu()}
                          for w in probe.window if w["update"] < len(losses)]}
    del probe, trainer, ds
    gc.collect()
    return out, program, inputs
