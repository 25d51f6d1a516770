"""The data axis of the device mesh: the port of eoe_tpu/parallel/mesh.py.

The JAX package runs one program over a ``(data, model)`` mesh of devices and
lets XLA insert the collectives. Here a rank is a process with one device,
and the data axis is a ``torch.distributed`` process group:

  * ``init_distributed`` joins a group of several processes when
    ``EOE_TPU_DISTRIBUTED=1`` (``EOE_TPU_COORD_ADDR``, ``EOE_TPU_NUM_PROCESSES``
    and ``EOE_TPU_PROCESS_ID``, the JAX package's variables);
    ``spawn_ranks`` starts ranks 1..n-1 of a group on this host, the caller
    being rank 0 (the runners' ``-d N``);
  * ``make_mesh`` returns a ``DataMesh``: the group, this rank, the data size
    and this rank's device, ``cuda:(local rank % cards)``. The collectives
    run on NCCL where each rank of a host owns a card of its own, and on
    gloo where ranks share a card (NCCL refuses two ranks on one device) or
    run on the CPU;
  * ``local_rows`` is the contiguous share of a global batch that a rank
    owns (``shard_batch``'s rows), ``gather_rows`` puts the ranks' rows back
    in global order, ``all_reduce_sum`` is a sum over the ranks whose
    gradient is the sum of the ranks' gradients (global batch-norm
    statistics), and ``active`` marks the block in which batch norm takes
    its statistics over the global batch.

The model axis (the Megatron split of ``_TP_RULES``, ``param_shardings``) is
not ported: ``make_mesh`` refuses ``model`` above 1.
"""

import atexit
import contextlib
import dataclasses
import datetime
import os
import socket
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh. ``data * model`` must equal #devices used."""
    data: int = -1   # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        if data * model > n_devices:
            raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n_devices}")
        return data, model


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data axis of ``data`` ranks: ``group`` carries the collectives,
    ``rank`` is this process's place on the axis and ``device`` its device."""
    group: object
    backend: str
    rank: int
    data: int
    device: torch.device
    model: int = 1
    note: str = ""   # the backend choice, as the trainer logs it


_distributed_initialized = False
_spawned = False          # this process is a rank that ``spawn_ranks`` started
_meshes: dict = {}        # make_mesh's, by (data, device type): one group each
# how long a spawned group waits for a rank (its start, or a collective) before
# it fails: every rank does the same work between two collectives
SPAWN_TIMEOUT = datetime.timedelta(minutes=10)


def _init_group(addr: Optional[str], world: int, rank: int, timeout=None):
    """The default process group over gloo; ``addr`` host:port, or None for
    torch's own ``env://`` variables."""
    kw = {} if timeout is None else {"timeout": timeout}
    if addr:
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world,
                                rank=rank, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def init_distributed():
    """Join the process group when EOE_TPU_DISTRIBUTED=1; a no-op otherwise
    or once a group exists. EOE_TPU_COORD_ADDR=host:port,
    EOE_TPU_NUM_PROCESSES and EOE_TPU_PROCESS_ID name the group (without the
    address, torch's ``env://`` variables). A group that fails to form warns
    and leaves this process alone, as the JAX package does."""
    global _distributed_initialized
    if _distributed_initialized or dist.is_initialized():
        return
    _distributed_initialized = True
    if os.environ.get("EOE_TPU_DISTRIBUTED", "0") != "1":
        return
    try:
        addr = os.environ.get("EOE_TPU_COORD_ADDR")
        _init_group(addr, int(os.environ["EOE_TPU_NUM_PROCESSES"]) if addr else -1,
                    int(os.environ["EOE_TPU_PROCESS_ID"]) if addr else -1)
        atexit.register(leave)   # the processes leave together as they end
    except Exception as exc:
        warnings.warn(
            f"EOE_TPU_DISTRIBUTED=1 but the process group did not form ({exc!r}); "
            f"continuing single-process: batches will NOT span processes", RuntimeWarning)


def data_size(devices: Optional[int], count: int) -> int:
    """The data size of ``-d devices`` on ``count`` devices: every device by
    default, at most ``count``; 1 or less means no mesh."""
    return count if devices is None else min(devices, count)


def make_mesh(config: Optional[MeshConfig] = None, device=None) -> DataMesh:
    """The data mesh over the ranks of the process group, this rank on
    ``device``'s type (``cuda`` unless the caller asks for another one). The
    data size must be the group's size; ``model`` above 1 is not ported. The
    backend choice is the mesh's ``note``; a backend that fails to start
    raises."""
    config = config or MeshConfig()
    if config.model > 1:
        raise NotImplementedError(
            f"a model axis of {config.model}: tensor parallelism (the JAX package's "
            f"_TP_RULES) is not ported yet (ROADMAP.md Queue 1, the model axis)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, _ = config.resolve(world)
    if data != world:
        raise ValueError(f"a data axis of {data} needs {data} ranks; the group has {world}")
    kind = torch.device("cuda" if device is None else device).type
    key = (data, kind)
    if key in _meshes:
        return _meshes[key]
    rank = dist.get_rank() if world > 1 else 0
    hosts = [socket.gethostname()] * world
    if world > 1:
        dist.all_gather_object(hosts, hosts[rank])
    local, on_host = hosts[:rank].count(hosts[rank]), hosts.count(hosts[rank])
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if on_host <= cards else "gloo"
    else:
        dev, backend = torch.device(kind), "gloo"
    group = dist.new_group(backend="nccl") if backend == "nccl" and world > 1 \
        else dist.group.WORLD
    note = (f"data mesh: rank {rank} of {world} on {dev}, collectives on {backend}"
            + (f" ({on_host} ranks share this host's {torch.cuda.device_count()} card(s))"
               if backend == "gloo" and kind == "cuda" else ""))
    mesh = _meshes[key] = DataMesh(group, backend, rank, data, dev, note=note)
    return mesh


def writes() -> bool:
    """Whether this process writes run directories: every process but the
    ranks that ``spawn_ranks`` started."""
    return not _spawned


# ---------------------------------------------------------------- rows


def local_rows(mesh: Optional[DataMesh], n: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) rows of an ``n``-row global batch that this
    rank owns: blocks of ceil(n / data) rows in rank order, the last ones
    shorter or empty where ``data`` does not divide ``n``."""
    if mesh is None or mesh.data == 1:
        return 0, n
    per = -(-n // mesh.data)
    return min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)


def gather_rows(mesh: Optional[DataMesh], x: torch.Tensor, n: int, dim: int = 0
                ) -> torch.Tensor:
    """Every rank's ``local_rows`` of an ``n``-row axis ``dim`` in global
    order, on every rank: each rank's rows in a zero-filled global buffer,
    summed over the ranks. The sum is exact (a value plus zeros), and an
    all-reduce takes CUDA tensors on gloo, which its all-gather does not."""
    if mesh is None or mesh.data == 1:
        return x
    lo, hi = local_rows(mesh, n)
    shape = list(x.shape)
    shape[dim] = n
    buf = x.new_zeros(shape)
    buf.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(buf, group=mesh.group)
    return buf


def gather_objects(mesh: DataMesh, obj) -> list:
    """Every rank's ``obj``, in rank order (pickled through the CPU)."""
    out = [None] * mesh.data
    dist.all_gather_object(out, obj)
    return out


def all_reduce_min(mesh: Optional[DataMesh], value: int) -> int:
    """The least of every rank's ``value``: a choice all ranks must share."""
    if mesh is None or mesh.data == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(t.item())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank. Its backward sums the
    ranks' gradients: each rank's loss is its share of the global loss, so
    the sum is the global loss's gradient of this rank's ``x``."""
    return _AllReduceSum.apply(x, mesh.group)


_active: Optional[DataMesh] = None


@contextlib.contextmanager
def active(mesh: Optional[DataMesh]):
    """Inside the block, train-mode batch norm takes its statistics over the
    global batch of ``mesh`` (when it has more than one rank)."""
    global _active
    prev, _active = _active, (mesh if mesh is not None and mesh.data > 1 else None)
    try:
        yield
    finally:
        _active = prev


def active_mesh() -> Optional[DataMesh]:
    return _active


# ---------------------------------------------------------------- ranks


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(i: int, fn: Callable, args: Sequence, port: int, n: int):
    global _spawned
    _spawned = True
    _init_group(f"localhost:{port}", n, i + 1, SPAWN_TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, args: Sequence, n: int):
    """Start ranks 1..n-1 of a group of ``n`` on this host (``spawn``, a free
    local port), each calling ``fn(*args)``, and join the group as rank 0.
    Returns the children's ``torch.multiprocessing`` context: the caller
    joins it, or terminates it when its own part fails."""
    port = free_port()
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, tuple(args), port, n), nprocs=n - 1, join=False,
        start_method="spawn")
    _init_group(f"localhost:{port}", n, 0, SPAWN_TIMEOUT)
    return ctx


def leave():
    """Destroy the process group and forget its meshes. Every rank calls it
    at the same point: NCCL's teardown can be collective."""
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
