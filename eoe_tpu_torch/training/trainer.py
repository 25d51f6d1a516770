"""Training engine: train and eval steps and the class x seed experiment grid.
The port of eoe_tpu/training/trainer.py.

One step takes a normal half and an OE half of raw uint8 images, runs each
through its (conditional ->) pipeline on the device, concatenates them, runs
the model forward on the whole batch in the compute dtype, casts the
features to fp32 for the loss, and updates the trainable parameters. The
batch weights are ``w * (labels >= 0)``, so padding slots and unlabeled
samples do not count. Train and test splits live on the device; a batch is
an index gather there, following the sampler's numpy plans.

The grid (``run``) builds each class-seed's dataset by name
(``datasets.load_dataset``, from the numpy rng of (seed, class, seed index),
as the JAX package does) unless one is pinned with ``trainer.ds``, trains
seeds one after another and retries a class-seed whose anomaly scores turned
NaN up to five times (``NanGradientsError``). With ``vmap_seeds`` (by
default for several seeds of a model trained from scratch, not CLIP, without
``load``) the seeds of a class whose train splits are resident train as one
program (``training.vmapped_seeds``) on one dataset built from the rng of
(seed, class, 0), as in the JAX package; on the card as many seeds a
program as its memory holds (measured, ``vmapped_seeds.seeds_per_program``),
sequentially where two do not fit. NaN scores, or the card running out of
memory, fall back to the sequential seeds. It writes the JAX package's run
directory (see ``utils.logger``). Models with batch norm update their
running averages in the train step and use them in eval; a conv model built
with ``dtype=None`` computes in the trainer's compute dtype. DSVDD's centre
is the mean feature of the normal train split under the initial weights
(``prepare_metric``); the AE objective gets the model's inputs. The
multi-scale modes (``msms``) are label-conditional pipelines that each
half-batch passes before the main pipeline, in training and in eval. A
split is resident when its source is (an array) or its source takes a split
of its size (``fits_resident``: a folder source within its RAM budget, a
blob within its own): it moves to the device once and its batches are
gathered there. Any other split streams: the normal and OE halves are
gathered on the host step by step, the test split batch by batch, and the
DSVDD centre's normal split likewise. The first seed of a class writes
preview grids of what the model sees (``training_cls{c}-{name}_preview.png``
and ``eval_cls{c}-{name}_preview.png``: raw images through the step's
pipelines, each image min-max normalised). A ``CustomNet`` with ``freeze``
trains only its head: the feature model's parameters get no gradient and no
decay, while its batch statistics still update. ``load`` takes a full
snapshot, a feature-model-only state dict of a ``CustomNet``, or a
trunk-only snapshot (a strict subset of the model's top-level modules; the
rest keeps its fresh init). Not ported, being JAX dispatch machinery: the
jit cache and the HLO dump.

The resident epoch (``training.graphs``), the counterpart of the JAX
package's ``lax.scan`` epochs: where both train halves are resident and
``graphs.scan_ok`` holds (the card, where a mesh's ranks each own a card,
or ``EOE_TPU_CPU_SCAN=1``), every remaining epoch's plan moves to the device
packed as int32 once (one epoch at a time above 64 MiB) and each step reads
its row at a device counter, gathers its halves there, runs ``train_step``
unchanged and writes (loss, scores, labels, weights) into a per-epoch
buffer: on the card captured as CUDA graphs of ``EOE_TPU_CHUNK`` steps
(``graphs.chunk_steps``) and replayed, uncaptured on the CPU. One download
per epoch either way, after the mesh's gathers.
``images_seen``, ``train_seconds`` and ``images_per_second`` count the
epochs of ``train_cls``, as in the JAX package.

``mesh`` (a ``parallel.mesh.Mesh`` of several ranks, one process each)
trains data-parallel with the numbers of one process on the global batch:
every rank runs the same sampler plan and uploads only its data index's
``local_rows`` of each half-batch; the augmentations draw for the global
half-batch from the shared generator and apply the rank's rows of the
draws; batch norm takes
the global batch's statistics; each rank's loss is scaled so that the mean
of the ranks' gradients is the gradient of the global masked mean: DDP's on
the per-step loop, the step's own flat all-reduce on the resident epoch
(``parallel.mesh.all_reduce_grads``, captured with the step where the ranks
run NCCL). The per-step losses, scores, labels and weights and the test
scores are gathered in global order at the end of an epoch, so every rank
logs, retries and decides alike. The DSVDD centre and the preview are
computed whole on every rank. Without a model axis the seed grid splits its
seeds over the ranks (``_last_vmap_sharded``), unevenly where the data size
does not divide them.

Under a model axis (``mesh.model`` above 1) every class-seed's weights are
drawn whole on every rank and cut to the rank's shards (``place_params``:
a copy of the model that holds them, made once; ``self.model`` stays whole
for the stacked engines): the CLIP encoders' Megatron split of
``parallel.mesh.param_shardings``, the rest replicated. The model ranks of a
data index see the same rows and draws; DDP runs over the data group. A
snapshot holds the full parameters and optimizer state (gathered over the
model group on every rank), and a load cuts them again. A mesh whose ranks
each own a card (NCCL) trains through the resident epoch, its collectives
captured in the graphs; ranks that share a card (gloo through the host,
which a graph cannot capture) train on the per-step loop.

Deviation: the sampler's seed comes from a numpy ``SeedSequence`` of
(seed, class, seed index) instead of a JAX key, and augmentations draw from
one ``torch.Generator`` per class-seed; the JAX package's random streams are
not reproduced.
"""

import copy
import gc
import time
import warnings
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from eoe_tpu_torch.datasets import load_dataset, no_classes, str_labels
from eoe_tpu_torch.datasets.bases import INF, BalancedEpochSampler, CombinedDataset
from eoe_tpu_torch.device import resolve_device
from eoe_tpu_torch.models.clip import CLIP
from eoe_tpu_torch.models.custom_base import CustomNet, frozen_param_labels
from eoe_tpu_torch.models.layers import with_compute_dtype
from eoe_tpu_torch.ops import metrics as M
from eoe_tpu_torch.ops.losses import OBJECTIVES, Objective, dsvdd_center
from eoe_tpu_torch.parallel import mesh as meshlib
from eoe_tpu_torch.training import graphs
from eoe_tpu_torch.training.optim import ScheduledOptimizer, make_optimizer
from eoe_tpu_torch.utils.logger import Logger
from eoe_tpu_torch.utils.profiling import span

AD_MODES = ("one_vs_rest", "leave_one_out", "fifty_fifty")


class NanGradientsError(RuntimeError):
    """Anomaly scores turned NaN during an epoch."""


class Result:
    """Per-class lists of per-seed metrics plus class means."""

    def __init__(self, n_classes: int):
        self.values: List[list] = [[] for _ in range(n_classes)]
        self.mean_values: List[Any] = [None] * n_classes

    def __getitem__(self, cls: int) -> list:
        return self.values[cls]

    def set_mean(self, cls: int, value):
        self.mean_values[cls] = value

    def mean(self, cls: int, on_none_return_latest=False):
        mean = self.mean_values[cls]
        latest = self.values[cls][-1] if len(self.values[cls]) > 0 else None
        return mean if mean is not None else (latest if on_none_return_latest else None)

    def means(self, on_none_return_latest=False) -> list:
        return [self.mean(c, on_none_return_latest) for c in range(len(self.mean_values))]

    def __iter__(self):
        return iter(self.values)


@dataclass
class TrainState:
    """The model (holding the parameters, on the device) and its optimizer,
    which counts the updates; under a data mesh either ``ddp``, the model's
    ``DistributedDataParallel`` wrapper that the train step runs (the
    per-step loop), or ``sum_grads``: the step sums the data axis's
    gradients itself after its backward (``parallel.mesh.all_reduce_grads``;
    the resident epoch, whose graphs capture it)."""
    model: torch.nn.Module
    optimizer: ScheduledOptimizer
    ddp: Optional[torch.nn.Module] = None
    sum_grads: bool = False


def _seed(*parts: int) -> int:
    """A 32-bit seed from non-negative integers."""
    return int(np.random.SeedSequence([max(int(p), 0) for p in parts]).generate_state(1)[0])


def _is_resident(subset) -> bool:
    """Whether a split moves to the device whole, or streams from the host."""
    return subset.source.resident or subset.source.fits_resident(len(subset))


def _local_draws(fn, x: torch.Tensor, rows: Tuple[int, int, int], rt_stats,
                 generator: torch.Generator) -> list:
    """Rows [lo, hi) of pipeline ``fn``'s draws for an ``n``-row batch of
    ``x``'s image shape, ``rows`` = (lo, hi, n)."""
    lo, hi, n = rows
    full = torch.zeros((), dtype=x.dtype, device=x.device).expand(n, *x.shape[1:])
    return [{k: v[lo:hi] for k, v in d.items()}
            for d in fn.draw(full, rt_stats, generator=generator)]


def _to_cpu(obj):
    """CPU copies of the tensors in ``obj``, a CPU tensor copied too: a
    snapshot is written in the background while the step goes on updating
    its tensors in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class Trainer:
    """The experiment-grid trainer. ``model`` is a port module (CLIP, or a
    conv model of ``models``); its weights are drawn anew for every
    class-seed with ``reset_parameters``. ``device`` is ``cuda`` unless the
    caller asks for another one; with a ``mesh`` it is the mesh's device."""

    # the per-step loop even where the resident epoch applies: the eager
    # control of the tests and chip_smoke.py (on the class: every trainer;
    # on an instance: that one)
    _per_step = False

    def __init__(self, model: torch.nn.Module, train_specs: Sequence, test_specs: Sequence,
                 dataset: str, oe_dataset: Optional[str], datapath: str, logger: Optional[Logger],
                 epochs: int, lr: float, wdk: float, milestones: Sequence[int], batch_size: int,
                 objective: Union[str, Objective] = "hsc", ad_mode: str = "one_vs_rest",
                 oe_limit_samples: Union[int, float, Sequence[int]] = INF,
                 oe_limit_classes: Union[int, float] = INF, msms: Sequence = (),
                 workers: int = 0, seed: int = 0, nominal_label: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 mesh: Optional[meshlib.Mesh] = None):
        assert ad_mode in AD_MODES, f"AD mode {ad_mode} unknown. Known modes are {AD_MODES}."
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self._ddp = None   # (trainable parameters' ids, DDP wrapper), built once
        self._tp = None    # under a model axis: (param_shardings, the sharded copy or None)
        self._last_vmap_sharded = False   # the last vmapped program's seeds were split
        self.model = model if model is None else with_compute_dtype(model, compute_dtype)
        self.objective: Objective = OBJECTIVES[objective] if isinstance(objective, str) \
            else objective
        self.train_specs = list(train_specs or ())
        self.test_specs = list(test_specs or ())
        self.dsstr = dataset
        self.oe_dsstr = oe_dataset
        self.datapath = datapath
        self.logger = logger if logger is not None else Logger("", active=False)
        self.epochs = epochs
        self.lr = lr
        self.wdk = wdk
        self.milestones = list(milestones or ())
        self.batch_size = batch_size
        self.ad_mode = ad_mode
        self.oe_limit_samples = oe_limit_samples
        self.oe_limit_classes = oe_limit_classes
        self.msms = list(msms or ())
        self.workers = workers
        self.seed = seed
        self.nominal_label = nominal_label
        self.compute_dtype = compute_dtype
        self.center = None
        self.ds = None  # a pinned, pre-built dataset
        self.epoch_rates: List[float] = []  # img/s per epoch
        self.step_losses: List[float] = []  # every step's loss, in order
        self.images_seen = 0                # images trained on by train_cls
        self.train_seconds = 0.0            # and its epochs' seconds
        self.member_peaks: dict = {}  # vmapped_seeds.members_per_program's, by shapes
        self.logger.logsetup(self.setup_dict(), step=0)
        if mesh is not None:
            self.logger.print(mesh.note)

    # ------------------------------------------------------------- config

    def setup_dict(self) -> dict:
        return {
            "model": type(self.model).__name__, "objective": self.objective.name,
            "train_specs": self.train_specs, "test_specs": self.test_specs,
            "dataset": self.dsstr, "oe_dataset": self.oe_dsstr, "datapath": self.datapath,
            "epochs": self.epochs, "lr": self.lr, "wdk": self.wdk, "milestones": self.milestones,
            "batch_size": self.batch_size, "ad_mode": self.ad_mode,
            "oe_limit_samples": (self.oe_limit_samples
                                 if not isinstance(self.oe_limit_samples, (list, np.ndarray))
                                 else list(map(int, self.oe_limit_samples))),
            "oe_limit_classes": self.oe_limit_classes,
            "msms": [str(m) for m in self.msms], "seed": self.seed,
            "nominal_label": self.nominal_label,
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
        }

    def get_nominal_classes(self, cur_class: int) -> List[int]:
        """The normal-class set of the AD mode."""
        if self.ad_mode == "one_vs_rest":
            return [cur_class]
        n = no_classes(self.dsstr)
        if self.ad_mode == "leave_one_out":
            return [c for c in range(n) if c != cur_class]
        if self.ad_mode == "fifty_fifty":
            return [c % n for c in range(cur_class, n // 2 + cur_class)]
        raise NotImplementedError(f"AD mode {self.ad_mode} unknown.")

    # ------------------------------------------------------------- model state

    def trainable_param_keys(self) -> Optional[frozenset]:
        """Top-level parameter names the loss trains; None = all. CLIP trains
        only the image tower: the text tower and ``logit_scale`` get no
        updates and no decay."""
        if isinstance(self.model, CLIP):
            return frozenset(["visual"])
        return None

    def _mark_trainable(self, model: torch.nn.Module) -> List[torch.nn.Parameter]:
        """The parameters the optimizer updates; the others get no gradient.
        A frozen CustomNet's feature model stays in train mode, so that its
        batch statistics update as the JAX step's do."""
        keys = self.trainable_param_keys()
        labels = frozen_param_labels(model, isinstance(model, CustomNet) and model.freeze)
        params = []
        for name, p in model.named_parameters():
            p.requires_grad_((keys is None or name.split(".")[0] in keys)
                             and labels[name] == "trainable")
            if p.requires_grad:
                params.append(p)
        return params

    def make_optimizer(self, params, steps_per_epoch: int) -> ScheduledOptimizer:
        """SGD with Nesterov momentum for CLIP, Adam for every other model."""
        kind = "sgd" if isinstance(self.model, CLIP) else "adam"
        return make_optimizer(kind, params, self.lr, self.wdk, self.milestones, steps_per_epoch)

    def init_weights(self, seed: int):
        """Fresh weights for a class-seed, drawn on the CPU."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))

    def init_state(self, seed: int, ds, steps_per_epoch: int) -> TrainState:
        """Fresh weights and optimizer for a class-seed; under a data mesh
        DDP for the per-step loop, the step's own gradient sum for the
        resident epoch (``resident_epoch``)."""
        self.init_weights(seed)
        model = self.place_params(self.model).to(self.device)
        params = self._mark_trainable(model)
        optimizer = self.make_optimizer(params, steps_per_epoch)
        if self._dp_mesh() is None or not params:
            return TrainState(model, optimizer)
        if self.resident_epoch(ds):
            if self._ddp is not None:
                # the DDP wrapper of an earlier per-step class-seed holds the
                # parameters' gradient accumulators, made on the stream it
                # ran on, which a capture on another stream cannot take
                self._ddp = None
                gc.collect()
            return TrainState(model, optimizer, sum_grads=True)
        return TrainState(model, optimizer, self._data_parallel(model, params))

    def place_params(self, model: torch.nn.Module) -> torch.nn.Module:
        """``model`` as this rank holds it: under a model axis where a rule of
        ``param_shardings`` applies, a copy (made once) loaded with this
        rank's shards of ``model``'s weights; ``model`` itself otherwise."""
        if self.mesh is None or self.mesh.model == 1:
            return model
        if self._tp is None:
            shardings = meshlib.param_shardings(self.mesh, model)
            held = None
            if any(shardings.values()):
                held = copy.deepcopy(model)
                meshlib.shard_module(held, self.mesh, shardings)
            self._tp = (shardings, held)
        shardings, held = self._tp
        if held is None:
            return model
        held.load_state_dict(meshlib.shard_params(self.mesh, model.state_dict(), shardings))
        return held

    def _shardings(self, state: TrainState) -> Optional[dict]:
        """``param_shardings`` of a state whose model holds shards, else None."""
        return self._tp[0] if self._tp is not None and state.model is self._tp[1] else None

    def _opt_tensors(self, model: torch.nn.Module, opt_state: dict, shardings: dict, fn) -> dict:
        """``opt_state`` (``ScheduledOptimizer.state_dict``) with each split
        parameter's per-parameter tensors (momentum, moments) through
        ``fn(tensor, split, mesh)`` (``parallel.mesh.shard_tensor`` or
        ``gather_tensor``); the state's indices follow the trainable
        parameters in their order."""
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        inner = opt_state["optimizer"]
        state = {i: {k: fn(v, shardings[names[i]], self.mesh) if torch.is_tensor(v) and v.dim()
                     and shardings[names[i]] else v for k, v in st.items()}
                 for i, st in inner["state"].items()}
        return {**opt_state, "optimizer": {**inner, "state": state}}

    def _dp_mesh(self) -> Optional[meshlib.Mesh]:
        """The mesh when its data axis has several ranks, else None."""
        return self.mesh if self.mesh is not None and self.mesh.data > 1 else None

    def _data_parallel(self, model: torch.nn.Module, params: list):
        """The model's DDP wrapper over the mesh's data group, built once for a
        set of trainable parameters (their values are drawn alike on every
        rank, so DDP broadcasts nothing; the batch-norm averages move alike,
        so it syncs no buffer). None without a mesh of several ranks, and
        where nothing trains (DDP refuses that)."""
        mesh = self._dp_mesh()
        if mesh is None or not params:
            return None
        key = tuple(map(id, params))
        if self._ddp is None or self._ddp[0] != key:
            from torch.nn.parallel import DistributedDataParallel
            with warnings.catch_warnings():   # newer torch names broadcast_buffers anew
                warnings.simplefilter("ignore", FutureWarning)
                self._ddp = (key, DistributedDataParallel(
                    model, device_ids=[mesh.device.index] if mesh.device.type == "cuda"
                    else None, process_group=mesh.group, broadcast_buffers=False,
                    init_sync=False))
        return self._ddp[1]

    def init_states_stacked(self, seeds: Sequence[int], steps_per_epoch: int):
        """The members of ``seeds`` as one ``StackedState``: each drawn on the
        CPU as ``init_weights`` draws it, the state dicts stacked there and
        moved to the device in one copy per dtype, one optimizer over the
        stacked trainable parameters."""
        from eoe_tpu_torch.training.vmapped_seeds import StackedState, upload_packed

        model = self.model.cpu()
        members = {}
        for seed in dict.fromkeys(seeds):   # a repeated seed is drawn once
            self.init_weights(seed)
            members[seed] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        names = members[seeds[0]].keys()
        stacked = upload_packed({k: torch.stack([members[s][k] for s in seeds]) for k in names},
                                self.device)
        model.to(self.device)
        self._mark_trainable(model)
        trainable = [n for n, p in model.named_parameters() if p.requires_grad]
        stacked = {n: torch.nn.Parameter(t) if n in trainable else t for n, t in stacked.items()}
        optimizer = self.make_optimizer([stacked[n] for n in trainable], steps_per_epoch)
        return StackedState(model, stacked, trainable, optimizer, self.objective,
                            self._loss_kwargs)

    # ------------------------------------------------------------- steps

    def _preprocess(self, ds, x, labels, generator, train: bool, part: str, rt_stats=None,
                    rows: Optional[Tuple[int, int, int]] = None):
        """One half-batch through (conditional ->) pipeline; ``part`` picks the
        normal or the OE dataset of a CombinedDataset (train only). ``rows``
        (lo, hi, n): ``x`` is rows [lo, hi) of an ``n``-row half-batch, and
        each pipeline draws for all ``n`` rows and applies rows [lo, hi) of
        its draws, which one process's pipeline over the ``n`` rows draws."""
        if isinstance(ds, CombinedDataset):
            sub = ds.oe if part == "oe" else ds.normal
        else:
            sub = ds
        pipe = sub.train_pipeline if train else sub.test_pipeline
        cond = sub.train_conditional_pipeline if train else sub.test_conditional_pipeline
        if rows is None or generator is None:
            x = cond(x, labels, rt_stats, generator=generator)
            return pipe(x, rt_stats, generator=generator)
        x = cond(x, labels, rt_stats, draws=_local_draws(cond, x, rows, rt_stats, generator))
        return pipe(x, rt_stats, draws=_local_draws(pipe, x, rows, rt_stats, generator))

    def _rt_stats(self, ds) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        stats = (ds.normal if isinstance(ds, CombinedDataset) else ds).stats
        if stats is None:
            return None
        return (torch.tensor(stats.mean, device=self.device),
                torch.tensor(stats.std, device=self.device))

    @torch.no_grad()
    def _transformed_preview(self, ds, percls: int, train: bool) -> np.ndarray:
        """What the model sees: up to ``percls`` raw images of each part
        (train: the normal and OE halves in label order; eval: each binary
        class of the test split) through the step's (conditional ->)
        pipelines, each image min-max normalised for display. (n, h, w, c)
        float in [0, 1]."""
        combined = isinstance(ds, CombinedDataset)
        normal_ds = ds.normal if combined else ds
        rt = self._rt_stats(ds)
        rows = []
        if train:
            parts = [("normal", ds.train_set, self.nominal_label)]
            if combined and len(ds.oe.train_set) > 0:
                parts.append(("oe", ds.oe.train_set, ds.anomalous_label))
            parts.sort(key=lambda p: p[2])
            for ki, (part, subset, label) in enumerate(parts):
                pos = np.arange(min(percls, len(subset)))
                gen = torch.Generator(device=self.device).manual_seed(ki)
                rows.append(self._preview_part(ds, subset, pos, label, gen, True, part, rt))
        else:
            binary = normal_ds.binary_targets(ds.test_set)
            for c in sorted(set(binary.tolist())):
                pos = np.argwhere(binary == c).flatten()[:percls]
                rows.append(self._preview_part(ds, ds.test_set, pos, c, None, False,
                                               "normal", rt))
        n = min(r.shape[0] for r in rows)
        out = torch.cat([r[:n].float() for r in rows])
        lo = out.amin(dim=(1, 2, 3), keepdim=True)
        hi = out.amax(dim=(1, 2, 3), keepdim=True)
        return ((out - lo) / (hi - lo).clamp_min(1e-9)).cpu().numpy()

    def _preview_part(self, ds, subset, pos, label, generator, train, part, rt):
        x = self._to_device(subset.gather(pos)).float() / 255.0
        labels = torch.full((len(pos),), label, dtype=torch.int64, device=self.device)
        return self._preprocess(ds, x, labels, generator, train, part, rt)

    def _loss_kwargs(self, inputs):
        kw = {"nominal_label": self.nominal_label}
        if self.objective.uses_inputs:
            kw["inputs"] = inputs
        return kw

    def train_step(self, state: TrainState, ds, xn, ln, xo, lo, w,
                   generator: Optional[torch.Generator], center=None, rt_stats=None):
        """One update on the normal half (+ the OE half). Returns the device
        tensors (loss, scores, labels, weights) without synchronising. Under
        a data mesh of several ranks the halves are this rank's
        ``local_rows`` of half-batches of ``batch_size`` rows, and the loss
        returned is this rank's share of the global masked mean (the ranks'
        shares sum to it). No host synchronisation: a CUDA graph captures
        it, collectives included (``graphs.scan_ok``)."""
        if xo is not None:
            labels, weights = torch.cat([ln, lo]), torch.cat([w, w])
        else:
            labels, weights = ln, w
        weights = weights * (labels >= 0)
        mesh, rows = self._dp_mesh(), None
        if mesh is not None:
            rows = (*meshlib.local_rows(mesh, self.batch_size), self.batch_size)
            assert len(xn) == rows[1] - rows[0], (len(xn), rows)
            total = meshlib.all_reduce_sum(weights.sum().float().reshape(1), mesh)
        xn = self._preprocess(ds, xn, ln, generator, True, "normal", rt_stats, rows)
        if xo is not None:
            xo = self._preprocess(ds, xo, lo, generator, True, "oe", rt_stats, rows)
            x = torch.cat([xn, xo])
        else:
            x = xn
        x = x.to(self.compute_dtype)
        model = state.model.train()
        with meshlib.active(mesh):
            feats = (model if state.ddp is None else state.ddp)(x).float()
            loss = self.objective.loss(feats, labels, center, weights=weights,
                                       **self._loss_kwargs(x))
            scaled = loss
            if mesh is not None:
                # this rank's sum(w * l) over the global weight sum; DDP takes
                # the mean of the ranks' gradients, hence the factor data
                loss = loss * (weights.sum().clamp(min=1.0) / total[0].clamp(min=1.0))
                scaled = loss * mesh.data
            state.optimizer.zero_grad()
            if loss.requires_grad:   # False where every parameter is frozen
                scaled.backward()
                if state.sum_grads:
                    meshlib.all_reduce_grads([p for p in state.model.parameters()
                                              if p.requires_grad], mesh)
        state.optimizer.step()
        with torch.no_grad():
            scores = self.objective.score(feats, center, **self._loss_kwargs(x)).reshape(-1)
        return loss.detach(), scores, labels, weights

    @torch.no_grad()
    def eval_step(self, state: TrainState, ds, x, labels, center=None, rt_stats=None):
        x = self._preprocess(ds, x, labels, None, False, "normal", rt_stats)
        x = x.to(self.compute_dtype)
        feats = state.model.eval()(x).float()
        return self.objective.score(feats, center, **self._loss_kwargs(x)).reshape(-1)

    # ------------------------------------------------------------- metric prep

    @torch.no_grad()
    def prepare_metric(self, clsstr: str, ds, state: TrainState, seed: int):
        """The objective's centre: for DSVDD the mean feature of the normal
        train split under the initial model in eval mode, each batch scaled
        to [0, 1] and through the train (conditional ->) pipeline, then
        ``dsvdd_center``. Every other objective here needs none."""
        if self.objective.name != "dsvdd":
            return None
        normal_ds = ds.normal if isinstance(ds, CombinedDataset) else ds
        train_set = ds.train_set
        n = len(train_set)
        X = self._to_device(train_set.gather_all()) if _is_resident(train_set) else None
        rt_stats = self._rt_stats(ds)
        generator = torch.Generator(device=self.device).manual_seed(_seed(self.seed, seed, 3))
        model = state.model.eval()
        feat_sum, B = None, self.batch_size
        for i in range(0, n, B):
            x = X[i:i + B] if X is not None else \
                self._to_device(train_set.gather(np.arange(i, min(i + B, n))))
            x = x.float() / 255.0
            labels = torch.full((len(x),), self.nominal_label, device=self.device)
            x = normal_ds.train_conditional_pipeline(x, labels, rt_stats, generator=generator)
            x = normal_ds.train_pipeline(x, rt_stats, generator=generator)
            s = model(x.to(self.compute_dtype)).float().sum(dim=0)
            feat_sum = s if feat_sum is None else feat_sum + s
        return dsvdd_center(feat_sum, n)

    # ------------------------------------------------------------- class x seed grid

    def run(self, run_classes: Optional[List[int]] = None, run_seeds: int = 1,
            load: Optional[List[List[str]]] = None, test: bool = True,
            train: bool = True, vmap_seeds: Optional[bool] = None) -> Tuple[None, dict]:
        """Iterate classes x seeds: build the dataset, train, evaluate,
        snapshot; write results.json. Returns (None, results): trained states
        are not kept in memory (the JAX package's KEEP_SNAPSHOT_IN_RAM is not
        ported). ``vmap_seeds`` trains the seeds of a class as one program
        where its splits are resident (else sequentially); None turns it on
        for several seeds trained from scratch, CLIP excepted (the pretrained
        weights make its members alike), as in the JAX package."""
        if vmap_seeds is None:
            vmap_seeds = train and run_seeds > 1 and load is None \
                and not self.objective.is_clip
        self.logger.logsetup({"run_classes": run_classes, "run_seeds": run_seeds,
                              "load": load}, step=1)
        classes = str_labels(self.dsstr)
        run_classes = run_classes if run_classes is not None else list(range(len(classes)))
        train_cls_rocs = Result(len(classes))
        eval_cls_rocs = Result(len(classes))
        eval_cls_prcs = Result(len(classes))
        assert self.ds is None or len(run_classes) == 1, \
            "pre-loading DS (setting trainer.ds) only allowed for one class"

        for c in run_classes:
            cstr = classes[c]
            vmapped = first = None
            if vmap_seeds and train and run_seeds > 1 and load is None:
                # seed 0's dataset: every vmapped seed's, else seed 0's own
                rng = np.random.default_rng([max(self.seed, 0), c, 0])
                first = (self._build_dataset(c, rng, None), rng)
                vmapped = self._try_vmap_seeds(c, cstr, run_seeds, first[0], test)
            self._last_grid_vmapped = vmapped is not None
            for it in range(run_seeds):
                self.logger.print(f'------ start training cls {c} "{cstr}" (seed {it}) ------')
                if vmapped is not None:
                    ds, state, roc = first[0], None, vmapped[0][it]
                else:
                    cur_load = load[c][it] if load is not None and len(load) > c \
                        and len(load[c]) > it else None
                    if it == 0 and first is not None:
                        ds, rng = first
                    else:
                        rng = np.random.default_rng([max(self.seed, 0), c, it])
                        ds = self._build_dataset(c, rng, cur_load)
                    state = roc = None
                    for attempt in range(5):
                        seed = _seed(self.seed, c, it, attempt)
                        try:
                            if train:
                                state, roc = self.train_cls(ds, c, cstr, it, seed, cur_load)
                            else:
                                state, _ = self._init_or_load(ds, seed, cur_load,
                                                              steps_per_epoch=1, optimizer=False)
                                roc = None
                            break
                        except NanGradientsError:
                            self.logger.warning(
                                f'Gradients got NaN for class {c} "{cstr}" and seed {it}. '
                                f'Happened {attempt} times so far. Try once more.')
                            ds = self._build_dataset(c, rng, None)
                            if attempt == 4:
                                state, roc = None, None
                                self.logger.warning(
                                    f'Gradients got NaN for class {c} "{cstr}" and seed {it}. '
                                    f'Giving up.')
                train_cls_rocs[c].append(roc)
                self.logger.plot_many(train_cls_rocs.means(True), classes,
                                      name="training_intermediate_roc")
                if test and (state is not None or vmapped is not None):
                    eroc, eprc = self.eval_cls(state, ds, c, cstr, it, scores=None
                                               if vmapped is None else vmapped[1][it])
                else:
                    eroc, eprc = None, None
                eval_cls_rocs[c].append(eroc)
                eval_cls_prcs[c].append(eprc)
                self.logger.plot_many(eval_cls_rocs.means(True), classes,
                                      name="eval_intermediate_roc")
                if state is not None:
                    self.snapshot(f"snapshot_cls{c}_it{it}", state, self.epochs,
                                  ds.ds_statistics)
                elif vmapped is not None and vmapped[2] is not None:
                    self._write_snapshot(f"snapshot_cls{c}_it{it}", *vmapped[2][it], self.epochs,
                                         ds.ds_statistics)

            train_cls_rocs.set_mean(c, self.logger.plot_many(
                train_cls_rocs[c], None, name=f"training_cls{c}-{cstr}_roc"))
            eval_cls_rocs.set_mean(c, self.logger.plot_many(
                eval_cls_rocs[c], None, name=f"eval_cls{c}-{cstr}_roc"))
            eval_cls_prcs.set_mean(c, self.logger.plot_many(
                eval_cls_prcs[c], None, name=f"eval_cls{c}-{cstr}_prc"))

        if any(t is not None for t in train_cls_rocs.means()):
            aucs = [m.auc for m in train_cls_rocs.means() if m is not None]
            self.logger.logtxt(f"Training: Overall {np.mean(aucs) * 100:04.2f}% "
                               f"+- {np.std(aucs) * 100:04.2f} AUC.")
            self.logger.plot_many(train_cls_rocs.means(), classes, name="training_roc")
        if test:
            e_aucs = [m.auc for m in eval_cls_rocs.means() if m is not None]
            e_aps = [m.avg_prec for m in eval_cls_prcs.means() if m is not None]
            mean_auc = float(np.mean(e_aucs)) if e_aucs else float("nan")
            std_auc = float(np.std(e_aucs)) if e_aucs else float("nan")
            mean_ap = float(np.mean(e_aps)) if e_aps else float("nan")
            std_ap = float(np.std(e_aps)) if e_aps else float("nan")
            self.logger.plot_many(eval_cls_rocs.means(), classes, name="eval_roc")
            self.logger.plot_many(eval_cls_prcs.means(), classes, name="eval_prc")
            self.logger.logtxt("--------------- OVERVIEW ------------------")
            self.logger.logtxt(f"Eval: Overall {mean_ap * 100:04.2f}% +- "
                               f"{std_ap * 100:04.2f}% AvgPrec.")
            for m, cs in zip(eval_cls_rocs.means(), classes):
                if m is not None:
                    self.logger.logtxt(f'Eval: Class "{cs}" yields {m.auc * 100:04.2f}% '
                                       f'+- {getattr(m, "std", 0.0) * 100:04.2f}% AUC.')
            self.logger.logtxt(f"Eval: Overall {mean_auc * 100:04.2f}% +- "
                               f"{std_auc * 100:04.2f}% AUC.")
        else:
            mean_auc = std_auc = mean_ap = float("nan")

        self.logger.logjson("results", {
            "eval_mean_auc": mean_auc, "eval_std_auc": std_auc, "eval_mean_avg_prec": mean_ap,
            "eval_cls_rocs": [[r.get_score() if r is not None else None for r in cr]
                              for cr in eval_cls_rocs],
            "classes": classes,
        })
        self.logger.flush_scalars()
        self.logger.drain()
        return None, {
            "mean_auc": mean_auc, "mean_avg_prec": mean_ap, "std_auc": std_auc,
            "cls_aucs": [[r.get_score() if r is not None else None for r in cr]
                         for cr in eval_cls_rocs],
        }

    def _try_vmap_seeds(self, c: int, cstr: str, run_seeds: int, ds, test: bool):
        """Train every seed of class ``c`` on ``ds`` as vmapped programs, as
        many seeds each as the card holds (``vmapped_seeds.seeds_per_program``),
        when its train splits are resident. Returns (train ROCs, test scores
        (run_seeds, n_test) or None without ``test``, each seed's host state
        for its snapshot or None with the logger off), or None: the caller
        then trains the seeds sequentially. Under a data mesh of several
        ranks without a model axis (``_last_vmap_sharded``) a program holds
        that many seeds a rank and each rank trains its ``local_rows`` of
        them, an uneven share where the data size does not divide them, with
        no collective in a step; every member's results are gathered in seed
        order before anything is logged. Under a model axis every rank runs
        every seed on the whole model. The ranks take the least of their
        program sizes, and a card running out of memory raises there."""
        from eoe_tpu_torch.training import vmapped_seeds as V

        oe_set = ds.oe.train_set if isinstance(ds, CombinedDataset) else None
        if not (_is_resident(ds.train_set) and (oe_set is None or _is_resident(oe_set))):
            return None
        dp = self._dp_mesh()
        self._last_vmap_sharded = shard = meshlib.splits(dp)
        mesh, ranks = (dp, dp.data) if shard else (None, 1)
        seeds = [_seed(self.seed, c, it, 0) for it in range(run_seeds)]
        most = -(-run_seeds // ranks)   # the largest share of a rank
        per = meshlib.all_reduce_min(dp, V.seeds_per_program(self, ds, cstr, seeds[:most]))
        if per < min(2, most):
            self.logger.print(f"two seeds of cls {c} do not fit on the card as one program; "
                              f"training them sequentially")
            return None
        rocs, scores, members = [], [], []   # in seed order
        caught = (NanGradientsError,) if dp is not None else \
            (NanGradientsError, torch.cuda.OutOfMemoryError)
        try:
            for first in range(0, run_seeds, per * ranks):
                n = min(per * ranks, run_seeds - first)
                stack, chunk_rocs = V.train_cls_vmapped_seeds(
                    self, ds, c, cstr, n, seeds[first:first + n], first=first, mesh=mesh)
                rocs.extend(chunk_rocs)
                lo, hi = meshlib.local_rows(mesh, n)
                if test:
                    sc = V.eval_scores_vmapped(self, ds, stack, hi - lo)
                    scores.extend(meshlib.gather_rows(
                        mesh, torch.from_numpy(sc).to(self.device), n).cpu().numpy())
                if shard:   # the snapshots' state of every rank's seeds
                    got = meshlib.gather_objects(mesh, [] if stack is None else
                                                 stack.host_members())
                    members.extend(m for part in got for m in part)
                elif self.logger.active:   # the snapshots' state, one download
                    members.extend(stack.host_members())
                del stack
        except caught as e:
            what = "Gradients got NaN" if isinstance(e, NanGradientsError) else \
                "The card ran out of memory"
            self.logger.warning(f'{what} in the vmapped-seed run for class {c} "{cstr}"; '
                                f"falling back to sequential training.")
            return None
        sharded = " (seed axis sharded over the data mesh)" if shard else ""
        self.logger.print(f"trained {run_seeds} seeds of cls {c} vmapped{sharded}"
                          + (f", {per} per program" if per < most else ""))
        return rocs, np.stack(scores) if test else None, members or None

    def _build_dataset(self, c: int, rng: np.random.Generator, cur_load: Optional[str]):
        """The pinned dataset, or the normal (+ OE) dataset of class ``c`` by
        name, with the statistics of the snapshot being resumed."""
        if self.ds is not None:
            return self.ds
        return load_dataset(
            self.dsstr, self.datapath, self.get_nominal_classes(c), self.nominal_label,
            self.train_specs, self.test_specs, self.logger, self.oe_dsstr,
            self.oe_limit_samples, self.oe_limit_classes, self.msms,
            ds_statistics=self.load_ds_statistics(cur_load), rng=rng)

    def load_ds_statistics(self, path: Optional[str]) -> Optional[dict]:
        """The dataset statistics stored in a snapshot, if any."""
        if path is None:
            return None
        self.logger.drain()   # the snapshot may still be on the background writer's queue
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return payload.get("ds_statistics") or None

    def load_epochs_only(self, path: Optional[str]) -> int:
        """The epoch stored in a snapshot; 0 without one."""
        if path is None:
            return 0
        self.logger.drain()
        return int(torch.load(path, map_location="cpu", weights_only=True).get("epoch", 0))

    def _init_or_load(self, ds, seed: int, cur_load: Optional[str],
                      steps_per_epoch: int, optimizer: bool = True) -> Tuple[TrainState, int]:
        state = self.init_state(seed, ds, steps_per_epoch)
        start_epoch = 0
        if cur_load is not None:
            state, start_epoch = self.load(cur_load, state, optimizer)
        return state, start_epoch

    # ------------------------------------------------------------- train one cls

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def resident_epoch(self, ds, stacked: bool = False) -> bool:
        """Whether ``train_cls`` trains ``ds`` through the resident epoch:
        both train halves resident and ``graphs.scan_ok``, as in the JAX
        package, which scans under any mesh. Its step runs the mesh's
        collectives, so on the card the mesh's ranks must each own a card
        (NCCL, which a graph captures); ranks that share one (gloo through
        the host) keep the per-step loop. A ``stacked`` program (the seeds
        or GA candidates) holds no collective and takes it under any mesh.
        An evaluation-only dataset (no train split) trains nothing."""
        mesh = None if stacked else self.mesh
        if self._per_step or ds.train_set is None or not graphs.scan_ok(self.device, mesh):
            return False
        oe_set = ds.oe.train_set if isinstance(ds, CombinedDataset) else None
        return _is_resident(ds.train_set) and (
            oe_set is None or len(oe_set) == 0 or _is_resident(oe_set))

    def train_cls(self, ds, cls: int, clsstr: str, it: int, seed: int,
                  cur_load: Optional[str] = None) -> Tuple[TrainState, Optional[M.ROC]]:
        train_set = ds.train_set
        combined = isinstance(ds, CombinedDataset)
        oe_set = ds.oe.train_set if combined else None
        has_oe = combined and len(oe_set) > 0
        sampler = BalancedEpochSampler(len(train_set), len(oe_set) if has_oe else 0,
                                       self.batch_size, _seed(seed, 1))
        state, start_epoch = self._init_or_load(ds, seed, cur_load, sampler.steps)
        if it == 0:
            self.write_train_preview(ds, cls, clsstr)
        center = self.center = self.prepare_metric(clsstr, ds, state, it)
        rt_stats = self._rt_stats(ds)
        normal_ds = ds.normal if combined else ds
        # a resident half moves to the device once; a streaming one keeps its
        # images on the host (X is None) and its labels in numpy
        Ln = normal_ds.binary_targets(train_set)
        Lo = ds.oe.binary_targets(oe_set) if has_oe else None
        Xn = Xo = None
        if _is_resident(train_set):
            Xn, Ln = self._to_device(train_set.gather_all()), self._to_device(Ln)
        if has_oe and _is_resident(oe_set):
            Xo, Lo = self._to_device(oe_set.gather_all()), self._to_device(Lo)
        generator = torch.Generator(device=self.device).manual_seed(_seed(seed, 2))
        runner = plans = None
        if self.resident_epoch(ds) and self.epochs > start_epoch:
            # every remaining epoch's plan, drawn up front as the per-step
            # loop draws them epoch by epoch
            plans = graphs.DevicePlans([graphs.pack_plan(*sampler.epoch()) for _ in range(
                start_epoch, self.epochs)], 1, self.device)
            runner, ep_out = self.make_train_epoch_resident(
                state, ds, (Xn, Ln, Xo, Lo), plans, sampler.steps, generator, center, rt_stats)

        cls_roc = None
        try:
            for ep in range(start_epoch, self.epochs):
                t0 = time.perf_counter_ns()
                with span("eoe.train.epoch", epoch=ep, steps=sampler.steps) as epoch:
                    epoch.stamp(t0)
                    if runner is not None:
                        with span("eoe.train.plan_load", epoch=ep):
                            plans.load(ep - start_epoch)
                        runner.run(sampler.steps)
                        n_halves = 2 if Xo is not None else 1
                        ep_losses, ep_scores, ep_labels, ep_weights = self._epoch_outputs(
                            ep_out[:, 0], ep_out[:, 1:].reshape(sampler.steps, 3, n_halves, -1)
                            .transpose(0, 1))
                    else:
                        ep_losses, ep_scores, ep_labels, ep_weights = self._train_epoch_steps(
                            state, ds, sampler, (Xn, Ln, Xo, Lo), generator, center, rt_stats)
                    seen = self.images_seen
                    cls_roc = self._log_epoch(cls, it, ep, t0, ep_losses, ep_scores, ep_labels,
                                              ep_weights, cls_roc)
                    epoch.add(images=self.images_seen - seen)
        finally:
            if runner is not None:
                runner.close()
        return state, cls_roc

    def _train_epoch_steps(self, state: TrainState, ds, sampler, halves, generator, center,
                           rt_stats):
        """One epoch as a loop of eager steps: the plan moves to the device
        once, a streamed half is gathered on the host step by step. Returns
        the epoch's (losses, scores, labels, weights) in numpy."""
        Xn, Ln, Xo, Lo = halves
        train_set = ds.train_set
        has_oe = isinstance(ds, CombinedDataset) and len(ds.oe.train_set) > 0
        oe_set = ds.oe.train_set if has_oe else None
        # this rank's rows of every half-batch (all of them in one process)
        mesh = self._dp_mesh()
        r0, r1 = meshlib.local_rows(mesh, self.batch_size)
        idx_n, idx_o, w = sampler.epoch()
        plan = torch.from_numpy(np.stack([
            idx_n, idx_o if has_oe else np.zeros_like(idx_n), w.astype(np.int64)])
        ).to(self.device)  # one upload per epoch
        outs = []
        for s in range(sampler.steps):
            i_n, i_o, w_s = plan[0, s, r0:r1], plan[1, s, r0:r1], plan[2, s, r0:r1].float()
            if Xn is not None:
                xn, ln = Xn[i_n], Ln[i_n]
            else:
                xn = self._to_device(train_set.gather(idx_n[s, r0:r1]))
                ln = self._to_device(Ln[idx_n[s, r0:r1]])
            xo = lo = None
            if Xo is not None:
                xo, lo = Xo[i_o], Lo[i_o]
            elif has_oe:
                xo = self._to_device(oe_set.gather(idx_o[s, r0:r1]))
                lo = self._to_device(Lo[idx_o[s, r0:r1]])
            outs.append(self.train_step(state, ds, xn, ln, xo, lo, w_s,
                                        generator, center, rt_stats))
        n_halves = 2 if has_oe else 1
        return self._epoch_outputs(torch.stack([o[0] for o in outs]), torch.stack([
            torch.stack([o[i].float().reshape(n_halves, -1) for o in outs]) for i in (1, 2, 3)]))

    def _epoch_outputs(self, losses: torch.Tensor, rest: torch.Tensor):
        """An epoch's outputs on the device, downloaded once (a per-step sync
        would stall the card): every step's loss (steps,) and its (scores,
        labels, weights) as (3, steps, half, row) of this rank's rows. A
        mesh sums the ranks' loss shares and gathers the rows in global
        order, as the JAX package downloads once an epoch. Returns (losses,
        scores, labels, weights) in numpy."""
        mesh = self._dp_mesh()
        with span("eoe.train.download"):
            if mesh is not None:
                losses = meshlib.all_reduce_sum(losses, mesh)
                rest = meshlib.gather_rows(mesh, rest, self.batch_size, dim=3)
            ep_scores, ep_labels, ep_weights = rest.reshape(3, -1).cpu().numpy()
            losses = losses.cpu().numpy()
        return losses, ep_scores, ep_labels.astype(np.int64), ep_weights

    def make_train_epoch_resident(self, state: TrainState, ds, halves, plans, steps: int,
                                  generator: torch.Generator, center, rt_stats):
        """The resident epoch's runner (``graphs.ResidentSteps``) and its
        per-epoch output buffer (steps, 1 + 3L): each step reads its plan
        row of ``plans`` (``graphs.DevicePlans``) at a device counter, takes
        this rank's ``local_rows`` of it (all of it in one process), gathers
        its halves from the resident ``halves`` (Xn, Ln, Xo, Lo), runs
        ``train_step`` (under a data mesh with the global batch's draws,
        batch-norm sums and gradient sum) and writes [loss share, scores,
        labels, weights] of its rows into row ``counter % steps``. Every
        rank draws the same global plans."""
        Xn, Ln, Xo, Lo = halves
        r0, r1 = meshlib.local_rows(self._dp_mesh(), self.batch_size)
        L = (2 if Xo is not None else 1) * (r1 - r0)
        out = torch.zeros(steps, 1 + 3 * L, device=self.device)
        cursor = torch.zeros(1, dtype=torch.int64, device=self.device)

        def step():
            i_n, i_o, w = plans.row(cursor)[:, r0:r1]
            xn, ln = Xn.index_select(0, i_n), Ln.index_select(0, i_n)
            xo = lo = None
            if Xo is not None:
                xo, lo = Xo.index_select(0, i_o), Lo.index_select(0, i_o)
            loss, scores, labels, weights = self.train_step(
                state, ds, xn, ln, xo, lo, w.float(), generator, center, rt_stats)
            row = torch.cat([loss.float().reshape(1), scores.float().reshape(-1),
                             labels.float().reshape(-1), weights.float().reshape(-1)])
            out.index_copy_(0, cursor % steps, row[None])
            cursor.add_(1)

        return graphs.ResidentSteps(step, self.device, graphs.chunk_steps(steps), [generator],
                                    [state.optimizer]), out

    def _log_epoch(self, cls: int, it: int, ep: int, t0: int, ep_losses, ep_scores,
                   ep_labels, ep_weights, cls_roc):
        """The epoch's accounting and logs after its download, the epoch
        having started at ``t0`` (``time.perf_counter_ns``); raises
        ``NanGradientsError`` on NaN scores. Returns the class ROC so far."""
        with span("eoe.train.log", epoch=ep):
            self.step_losses.extend(map(float, ep_losses))
            dt = (time.perf_counter_ns() - t0) * 1e-9
            n_imgs = int(ep_weights.sum())
            self.images_seen += n_imgs
            self.train_seconds += dt
            self.epoch_rates.append(n_imgs / max(dt, 1e-9))
            keep = ep_weights > 0
            ep_scores, ep_labels = ep_scores[keep], ep_labels[keep]
            if np.isnan(ep_scores).sum() > 0:
                raise NanGradientsError()
            self.logger.hist(f"Training: CLS{cls} SEED{it} anomaly_scores normal",
                             ep_scores[ep_labels == 0], ep)
            if (ep_labels == 1).sum() > 0:
                self.logger.hist(f"Training: CLS{cls} SEED{it} anomaly_scores anomalous",
                                 ep_scores[ep_labels == 1], ep)
                cls_roc = M.roc_curve(ep_labels, ep_scores)
                self.logger.add_scalar(f"Training: CLS{cls} SEED{it} AUC", cls_roc.auc * 100, ep)
            self.logger.add_scalar(f"training_cls{cls}_seed{it}_loss",
                                   float(ep_losses.mean()), ep)
            self.logger.print(
                f"cls {cls} seed {it} epoch {ep + 1}/{self.epochs}: loss {ep_losses.mean():.5f}"
                + (f", train AUC {cls_roc.auc * 100:.2f}%" if cls_roc is not None else "")
                + f", {n_imgs / max(dt, 1e-9):.0f} img/s")
            return cls_roc

    def write_train_preview(self, ds, cls: int, clsstr: str):
        """``training_cls{cls}-{clsstr}_preview.png``, which the first seed of
        a class writes."""
        if self.logger.active:
            counts = ds.n_normal_anomalous()
            self.logger.logimg(f"training_cls{cls}-{clsstr}_preview",
                               self._transformed_preview(ds, 40, train=True),
                               rowheaders=[str(counts[k]) for k in sorted(counts)])

    # ------------------------------------------------------------- eval

    def test_batches(self, ds, rows: Optional[Tuple[int, int]] = None):
        """The test split's raw images and labels on the device, in batches of
        the batch size (the last one padded by repeating its last image), or
        rows [lo, hi) of each batch. A resident split moves to the device
        once; a streaming one batch by batch."""
        test_set = ds.test_set
        normal_ds = ds.normal if isinstance(ds, CombinedDataset) else ds
        labels = normal_ds.binary_targets(test_set)
        n, B = len(test_set), self.batch_size
        lo, hi = rows or (0, B)
        total = -(-n // B) * B
        pad = np.concatenate([np.arange(n), np.full(total - n, n - 1)])
        if _is_resident(test_set):
            X = self._to_device(test_set.gather_all())[self._to_device(pad)]
            L = self._to_device(labels[pad])
            return ((X[i + lo:i + hi], L[i + lo:i + hi]) for i in range(0, total, B))
        return ((self._to_device(test_set.gather(pad[i + lo:i + hi])),
                 self._to_device(labels[pad[i + lo:i + hi]])) for i in range(0, total, B))

    def eval_scores(self, state: TrainState, ds) -> np.ndarray:
        """Anomaly scores of the whole test split (``test_batches``); under a
        data mesh each rank scores its rows of every batch, gathered in
        order."""
        rt_stats = self._rt_stats(ds)
        mesh = self._dp_mesh()
        outs = [self.eval_step(state, ds, x, lb, self.center, rt_stats)
                for x, lb in self.test_batches(ds, meshlib.local_rows(mesh, self.batch_size))]
        scores = meshlib.gather_rows(mesh, torch.stack(outs), self.batch_size, dim=1)
        return scores.reshape(-1).cpu().numpy()[:len(ds.test_set)]

    def eval_cls(self, state: TrainState, ds, cls: int, clsstr: str, it: int,
                 scores: Optional[np.ndarray] = None
                 ) -> Tuple[Optional[M.ROC], Optional[M.PRC]]:
        """Evaluate on the full test split; writes
        ``eval_cls{cls}_it{it}_anomaly_scores.json``."""
        test_set = ds.test_set
        normal_ds = ds.normal if isinstance(ds, CombinedDataset) else ds
        labels = normal_ds.binary_targets(test_set)
        if it == 0 and self.logger.active:
            counts = ds.n_normal_anomalous(False)
            self.logger.logimg(f"eval_cls{cls}-{clsstr}_preview",
                               self._transformed_preview(ds, 20, train=False),
                               rowheaders=[f"{k}: {v}" for k, v in sorted(counts.items())])
        scores = self.eval_scores(state, ds) if scores is None else np.asarray(scores)
        keep = labels >= 0
        for lbl, tag in ((0, "nominal"), (1, "anomalous")):
            if (labels == lbl).sum() > 0:
                self.logger.hist(f"Eval: (SD{it}) anomaly_scores cls{cls} {tag}",
                                 scores[labels == lbl], 0)
        if (labels == 0).sum() > 0 and (labels == 1).sum() > 0:
            cls_roc = M.roc_curve(labels[keep], scores[keep])
            cls_prc = M.precision_recall_curve(labels[keep], scores[keep])
            self.logger.logtxt(
                f'Eval: class "{clsstr}" yields {cls_roc.auc * 100:04.2f}% AUC and '
                f"{cls_prc.avg_prec * 100:04.2f}% average precision (seed {it}).")
        else:
            cls_roc = cls_prc = None
        self.logger.logjson(f"eval_cls{cls}_it{it}_anomaly_scores",
                            self._anomaly_score_dict(ds, scores))
        return cls_roc, cls_prc

    def _anomaly_score_dict(self, ds, scores: np.ndarray) -> dict:
        """Per-sample scores keyed by test index, or by the source's sample
        keys where it has them."""
        test_set = (ds.normal if isinstance(ds, CombinedDataset) else ds).test_set
        keys = test_set.sample_keys
        if keys is not None:
            return {str(k): float(v) for k, v in zip(keys, scores)}
        return {int(i): float(v) for i, v in zip(test_set.indices, scores)}

    # ------------------------------------------------------------- snapshots

    def snapshot(self, name: str, state: TrainState, epoch: int,
                 ds_statistics: Optional[dict]) -> str:
        """Writes the full parameters and optimizer state: under a model axis
        gathered over the model group first, on every rank (collective)."""
        params, opt_state = state.model.state_dict(), state.optimizer.state_dict()
        shardings = self._shardings(state)
        if shardings is not None:
            params = meshlib.gather_params(self.mesh, params, shardings)
            opt_state = self._opt_tensors(state.model, opt_state, shardings,
                                          meshlib.gather_tensor)
        return self._write_snapshot(name, params, opt_state, epoch, ds_statistics)

    def _write_snapshot(self, name: str, params: dict, opt_state: dict, epoch: int,
                        ds_statistics: Optional[dict]) -> str:
        if not self.logger.active:
            return ""
        payload = {
            "params": _to_cpu(params),
            "opt_state": _to_cpu(opt_state),
            "epoch": epoch,
            "ds_statistics": ds_statistics or {},
            "setup": self.setup_dict(),
        }
        return self.logger.snapshot(name, payload)

    def load(self, path: str, state: TrainState,
             optimizer: bool = True) -> Tuple[TrainState, int]:
        """Load a snapshot into an initialised state; returns (state, epoch).
        A payload without "params" is a state dict of a CustomNet's feature
        model alone (its parameters, and its batch statistics where it holds
        them): loaded into ``feature_model``, epoch 0. A snapshot whose
        top-level modules are a strict subset of the model's is a trunk-only
        one: the stored modules and their batch statistics are restored, the
        rest keeps its fresh init, and the optimizer starts anew at epoch 0.
        An evaluation-only run (``optimizer=False``) leaves the optimizer
        state alone: the snapshot may come from a run that trained other
        parameters (a frozen feature model)."""
        self.logger.drain()
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model = state.model
        if "params" not in payload:
            if not isinstance(model, CustomNet):
                raise ValueError(f"{path} holds no 'params': a feature-model state dict "
                                 f"loads only into a CustomNet")
            feature_model = getattr(model, CustomNet.FEATURE_COLLECTION)
            missing, unexpected = feature_model.load_state_dict(payload, strict=False)
            params = dict(feature_model.named_parameters())
            if unexpected or any(k in params for k in missing):
                raise RuntimeError(
                    f"{path} is not a state dict of the feature model: missing "
                    f"{[k for k in missing if k in params]}, unexpected {unexpected}")
            self.logger.print("Loaded pre-trained weights for feature model of CustomNet.")
            return state, 0
        stored = {k.split(".")[0] for k in payload["params"]}
        modules = {k.split(".")[0] for k in model.state_dict()}
        if stored < modules:
            want = {k for k in model.state_dict() if k.split(".")[0] in stored}
            if set(payload["params"]) != want:
                raise RuntimeError(f"{path}: the stored modules {sorted(stored)} do not match "
                                   f"the model's: {sorted(want ^ set(payload['params']))}")
            model.load_state_dict(payload["params"], strict=False)
            missing = sorted({k.split(".")[0] for k, _ in model.named_parameters()} - stored)
            self.logger.print(f"Loaded trunk-only snapshot; fresh init kept for {missing}")
            return state, 0
        params, opt_state = payload["params"], payload.get("opt_state")
        shardings = self._shardings(state)
        if shardings is not None:   # a full snapshot, cut to this rank's shards
            params = meshlib.shard_params(self.mesh, params, shardings)
            if opt_state:
                opt_state = self._opt_tensors(model, opt_state, shardings, meshlib.shard_tensor)
        model.load_state_dict(params)
        if optimizer and opt_state:
            state.optimizer.load_state_dict(opt_state)
        epoch = int(payload.get("epoch", 0))
        self.logger.print(f"Loaded snapshot at epoch {epoch}")
        return state, epoch

    # ------------------------------------------------------------- throughput

    @property
    def images_per_second(self) -> float:
        """Images trained on over the seconds of ``train_cls``'s epochs."""
        return self.images_seen / self.train_seconds if self.train_seconds > 0 else 0.0
