"""The resident epoch: captured CUDA graphs of the training step. The port of
the JAX package's ``lax.scan`` epochs (``scan_ok`` and
``make_train_epoch_resident``, eoe_tpu/training/trainer.py:47-56, 787-882,
956-987; the stacked seeds, eoe_tpu/training/vmapped_seeds.py:147-189; the
GA's candidates, eoe_tpu/evolve/vmapped.py:73-93).

Where both train halves are resident, a step reads all it needs from tensors
that stay in place for the run: the packed int32 index plans of every
remaining epoch (``DevicePlans``: one upload where they take at most 64 MiB,
else one epoch at a time into the same buffer), a step counter on the
device that picks the plan row, the resident images and labels, the
parameters and the optimizer state; it writes its outputs into a
preallocated buffer and adds one to the counter. ``ResidentSteps`` runs
such a step:

* the optimizer state is made before the first step
  (``ScheduledOptimizer.make_capturable``), so that it does not keep
  segments of the step's freed activations reserved outside the capture's
  pool; the first ``chunk`` steps of a class-seed (or of a stacked
  program) run eagerly on a side stream, as real steps of the plan: they
  do what a first call does (kernel builds, constant caches, shared-memory
  limits, cuBLAS and cuDNN workspaces and algorithms) outside the capture;
* then ``chunk`` steps are captured into one ``torch.cuda.CUDAGraph``, which
  each further group of ``chunk`` steps replays; ``chunk_steps`` takes
  ``EOE_TPU_CHUNK`` where it divides the epoch, else the epoch, and one
  step without it (``DEFAULT_CHUNK``; the JAX package's default is the
  epoch);
* every generator the step draws from is registered with the graph: a
  replay draws from the generator's state at that point what the eager
  steps would, and moves its offset on as they would;
* what the host counts in a step moves with the replays: the optimizers'
  update counts (a graph holds the learning rates of its capture, and is
  captured anew where the schedule moves: ``ScheduledOptimizer.rates``) and
  the kernels' launch counters (the capture's increments are taken back and
  added at every replay, so the counters count launches on the card);
* a capture that fails raises, after ending the capture (an out-of-memory
  error stays one); nothing falls back to the per-step loop;
* ``close`` drops the graph with its private memory pool and the gradients
  allocated in it. A graph is bound to the addresses of its tensors: a new
  class-seed, a NaN retry or a load builds a new runner.

Under a mesh of several ranks (``scan_ok``'s ``mesh``) the step holds the
mesh's collectives: the data axis's gradient sum
(``parallel.mesh.all_reduce_grads``, in DDP's place), batch norm's global
sums and the model axis's two products' sums. Where each rank owns a card
they run on NCCL, which a graph captures: the first eager step makes every
communicator, and where a process group exists the capture is
thread-local, so that the group's watchdog threads may query their events
meanwhile. Every rank captures and replays its steps in one order. Ranks
that share a card run gloo through the host, which no graph captures: their
step stays on the per-step loop. A stacked program (seeds, GA candidates)
holds no collective and takes the graphs under any mesh.

Off the card (``EOE_TPU_CPU_SCAN=1``), the same step runs uncaptured over the
same buffers and counter, on gloo ranks too. The trainers keep their
per-step loop for a streamed half, for ranks that share a card, on the CPU
without ``EOE_TPU_CPU_SCAN=1``, and where ``trainer._per_step`` is set (the
eager control of the tests and ``chip_smoke.py``).
"""

import os
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from eoe_tpu_torch.utils.profiling import span

PLAN_BYTES = 64 << 20      # the most that one upload of every epoch's plans holds
# steps a graph holds without EOE_TPU_CHUNK (0: the whole epoch, the JAX
# package's default). One: its capture costs one step of host time and only
# the first step runs eagerly, where a whole-epoch graph runs its first
# epoch eagerly and captures one epoch's host time: a 2-epoch CNN32 run of
# 16 steps an epoch took 0.23 s against 0.50-0.56 s on an H100 (PERF.md)
DEFAULT_CHUNK = 1


def scan_ok(device, mesh=None) -> bool:
    """Whether the resident epoch is taken on ``device`` by a step that runs
    the collectives of ``mesh`` (a ``parallel.mesh.Mesh``, or None for a
    step without any): on the CPU where ``EOE_TPU_CPU_SCAN=1`` forces it
    (for the tests), and on the card where the collectives can be captured,
    on NCCL (one card a rank) or with one rank."""
    if torch.device(device).type != "cuda":
        return os.environ.get("EOE_TPU_CPU_SCAN") == "1"
    return mesh is None or mesh.size == 1 or mesh.backend == "nccl"


def chunk_steps(steps: int) -> int:
    """The steps one graph holds: ``EOE_TPU_CHUNK`` where it divides the
    epoch's ``steps``, else the whole epoch (as in the JAX package); without
    it ``DEFAULT_CHUNK``."""
    chunk = int(os.environ.get("EOE_TPU_CHUNK", "0") or 0) or DEFAULT_CHUNK or steps
    return chunk if 0 < chunk <= steps and steps % chunk == 0 else steps


def pack_plan(idx_n: np.ndarray, idx_o: Optional[np.ndarray], w: np.ndarray) -> np.ndarray:
    """One epoch's plan as int32 (3, ..., B): normal positions, OE positions
    (zeros without OE), weights. The sampler's weights are a {0, 1} mask."""
    assert np.array_equal(w, w.astype(np.int32)), \
        "non-integer sampler weights cannot ride the packed int32 plan"
    return np.stack([idx_n, idx_o if idx_o is not None else np.zeros_like(idx_n), w]
                    ).astype(np.int32)


class DevicePlans:
    """Every epoch's packed plan on the device, the epochs concatenated on
    step axis ``axis``: one upload where they take at most ``PLAN_BYTES``,
    else one epoch at a time into one buffer (``load``)."""

    def __init__(self, plans: Sequence[np.ndarray], axis: int, device):
        self.axis = axis
        whole = sum(p.nbytes for p in plans) <= PLAN_BYTES
        self._per_epoch = None if whole else list(plans)
        self.tensor = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(plans, axis) if whole else plans[0])).to(device)
        self.rows = self.tensor.shape[axis]

    def load(self, epoch: int):
        """Make epoch ``epoch`` (counted from the first planned one) readable."""
        if self._per_epoch is not None and epoch > 0:
            self.tensor.copy_(torch.from_numpy(self._per_epoch[epoch]))

    def row(self, cursor: torch.Tensor) -> torch.Tensor:
        """The plan row of step ``cursor`` (a (1,) int64 device tensor):
        (3, ..., B) with the step axis gone."""
        return self.tensor.index_select(self.axis, cursor % self.rows).squeeze(self.axis)


_SIDE_STREAMS: dict = {}   # device -> the stream of every runner's eager steps and captures


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device, shared by every runner: cuBLAS keeps a
    workspace for each stream it has run on."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _launch_counters() -> List[Tuple[object, str]]:
    """Every kernel launch counter of the port: (owner, attribute)."""
    from eoe_tpu_torch.ops import augment, cbam
    from eoe_tpu_torch.ops.attention import flash_attention, fused_qkv_attention
    return ([(fused_qkv_attention, a) for a in (
        "launches", "bwd_launches", "group_launches", "group_bwd_launches",
        "resident_bwd_launches", "recompute_bwd_launches")]
        + [(flash_attention, a) for a in ("launches", "tc_launches", "tile_launches")]
        + [(augment, "launches"), (augment, "stats_launches")]
        + [(cbam, "launches"), (cbam, "bwd_launches")])


def read_launches() -> List[int]:
    return [getattr(o, a) for o, a in _launch_counters()]


def _set_launches(values: Sequence[int]):
    for (o, a), v in zip(_launch_counters(), values):
        setattr(o, a, v)


def _add_launches(delta: Sequence[int]):
    _set_launches([v + d for v, d in zip(read_launches(), delta)])


class ResidentSteps:
    """Runs ``step`` (a training step over static buffers, see the module
    docstring) as captured CUDA graphs of ``chunk`` steps on the card, and
    directly elsewhere. ``generators`` are the generators ``step`` draws
    from, ``optimizers`` the ``ScheduledOptimizer``s it steps."""

    def __init__(self, step: Callable[[], None], device, chunk: int,
                 generators: Sequence[torch.Generator] = (), optimizers: Sequence = ()):
        self.step, self.chunk = step, chunk
        self.device = torch.device(device)
        self.captured = self.device.type == "cuda"
        if self.captured and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generators = list({id(g): g for g in generators if g is not None}.values())
        self.optimizers = list(optimizers)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0          # graphs captured so far
        self.replays = 0
        # host seconds of the captures: making room (a synchronise and
        # empty_cache), recording the steps, ending (instantiating the graph)
        self.capture_seconds = [0.0, 0.0, 0.0]
        self._eager_left = chunk   # steps to run before the first capture
        self._rates = None         # the learning rates the graph holds
        self._launches = None      # the launch counters' increments of one replay
        if self.captured:
            for opt in self.optimizers:
                opt.make_capturable()
            self._stream = _side_stream(self.device)

    def run(self, n: int):
        """The next ``n`` steps, a whole number of chunks."""
        assert n % self.chunk == 0, (n, self.chunk)
        if not self.captured:
            for _ in range(n // self.chunk):
                with span("eoe.train.chunk", steps=self.chunk):
                    for _ in range(self.chunk):
                        self.step()
            return
        done = min(n, self._eager_left)
        if done:
            self._eager(done)
            self._eager_left -= done
        while done < n:
            rates = [opt.rates(self.chunk) for opt in self.optimizers]
            if self.graph is None or rates != self._rates:
                self._capture(rates)
            with span("eoe.train.chunk", steps=self.chunk):
                self.graph.replay()
            self.replays += 1
            for opt in self.optimizers:
                opt.count += self.chunk
            _add_launches(self._launches)
            done += self.chunk

    def _eager(self, n: int):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream), warnings.catch_warnings():
            # torch warns once that a capturable optimizer steps uncaptured
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            for _ in range(n):
                self.step()
        cur.wait_stream(self._stream)

    def _capture(self, rates: list):
        self._drop_graph()
        for opt in self.optimizers:   # release the last step's gradients outside the capture
            opt.zero_grad()
        launches, counts = read_launches(), [opt.count for opt in self.optimizers]
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()   # cached blocks the private pool may need
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        t1 = time.perf_counter()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(capture_error_mode="thread_local" if dist.is_initialized()
                                    else "global")
                try:
                    for _ in range(self.chunk):
                        self.step()
                except BaseException:
                    _end_failed_capture(graph, self.device)
                    raise
                t2 = time.perf_counter()
                graph.capture_end()
            for i, dt in enumerate((t1 - t0, t2 - t1, time.perf_counter() - t2)):
                self.capture_seconds[i] += dt
        finally:   # the capture launched nothing and updated nothing
            self._launches = [b - a for a, b in zip(launches, read_launches())]
            _set_launches(launches)
            for opt, c in zip(self.optimizers, counts):
                opt.count = c
        self.graph, self._rates = graph, rates
        self.captures += 1

    def _drop_graph(self):
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None

    def close(self):
        """Free the graph, its private pool and the gradients allocated in it."""
        if self.captured:
            self._drop_graph()
            for opt in self.optimizers:
                opt.zero_grad()


def _end_failed_capture(graph, device: torch.device):
    """End a capture whose step raised, so that the card and the allocator
    work on; the step's exception is the one to report."""
    try:
        graph.capture_end()
    except RuntimeError:   # the capture was invalidated: route no more allocations to it
        try:
            torch._C._cuda_endAllocateToPool(device.index, graph.pool())
        except Exception:   # noqa: BLE001 - best effort; the step's error is raised
            pass
    try:
        graph.reset()
    except Exception:   # noqa: BLE001 - as above
        pass
