"""The ``(data, model)`` device mesh: the port of eoe_tpu/parallel/mesh.py.

The JAX package runs one program over a ``(data, model)`` mesh of devices and
lets XLA insert the collectives. Here a rank is a process with one device,
and each axis is a set of ``torch.distributed`` process groups:

  * ``init_distributed`` joins a group of several processes when
    ``EOE_TPU_DISTRIBUTED=1`` (``EOE_TPU_COORD_ADDR``, ``EOE_TPU_NUM_PROCESSES``
    and ``EOE_TPU_PROCESS_ID``, the JAX package's variables);
    ``spawn_ranks`` starts ranks 1..n-1 of a group on this host, the caller
    being rank 0 (the runners' ``-d N``);
  * ``make_mesh`` returns a ``Mesh`` of ``data * model`` ranks: world rank
    ``r`` sits at data index ``r // model`` and model index ``r % model``, as
    JAX's ``reshape(data, model)`` of the devices places it. The mesh holds
    this rank's data group (the ranks of its model index: DDP, batch-norm
    statistics, row gathers) and model group (the ranks of its data index:
    the tensor-parallel products), and its device, ``cuda:(local rank %
    cards)``. The collectives run on NCCL where each rank of a host owns a
    card of its own, and on gloo where ranks share a card (NCCL refuses two
    ranks on one device) or run on the CPU;
  * ``local_rows`` is the contiguous share of a global batch that a data
    index owns (``shard_batch``'s rows; every model rank of it owns the
    same rows), ``gather_rows`` puts the data axis's rows back in global
    order, ``all_reduce_sum`` is a sum over the data axis whose gradient is
    the sum of the ranks' gradients (global batch-norm statistics),
    ``active`` marks the block in which batch norm takes its statistics
    over the global batch, and ``all_reduce_grads`` sums a step's
    gradients over the data axis in DDP's place (the resident epoch, whose
    CUDA graphs capture the collectives on NCCL); ``splits`` says whether
    seeds and GA candidates split over the data axis;
  * the model axis is the JAX package's Megatron split of the CLIP
    encoders (``_TP_RULES``, ``param_shardings``): ``qkv`` and ``mlp_up``
    split their outputs, ``attn_out`` and ``mlp_down`` their inputs.
    ``shard_params`` cuts a full state into this rank's shards,
    ``gather_params`` puts them back together, ``shard_module`` makes a
    module hold its shards, and ``copy_to_model`` / ``reduce_from_model``
    are the two collectives of a split product. The split of ``qkv`` is by
    heads: a rank takes its slice of each of the q, k and v blocks, so its
    projection is the fused attention's input for its own heads; where the
    model size does not divide the heads, ``qkv`` and ``attn_out`` stay
    whole (JAX splits their columns wherever the size divides them).
"""

import atexit
import contextlib
import dataclasses
import datetime
import os
import socket
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

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
class Mesh:
    """A ``data x model`` mesh of ranks, one process each. ``rank`` and
    ``model_rank`` are this process's indices on the two axes, ``group`` the
    data group (the ``data`` ranks of its model index) and ``model_group``
    the model group (the ``model`` ranks of its data index; None without a
    model axis); ``device`` is this rank's device."""
    group: object
    backend: str
    rank: int
    data: int
    device: torch.device
    model: int = 1
    model_rank: int = 0
    model_group: object = None
    note: str = ""   # the layout and backend, as the trainer logs it

    @property
    def size(self) -> int:
        return self.data * self.model


_distributed_initialized = False
_spawned = False          # this process is a rank that ``spawn_ranks`` started
_meshes: dict = {}        # make_mesh's, by (data, model, device type)
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


def _subgroup(blocks: Sequence[Sequence[int]], backend: str, rank: int):
    """A group for each block of world ranks, made by every rank in one
    order (``new_group`` is collective over the world); this rank's."""
    mine = None
    for ranks in blocks:
        group = dist.new_group(list(ranks), backend=backend)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(config: Optional[MeshConfig] = None, device=None) -> Mesh:
    """The ``data x model`` mesh over the ranks of the process group, this
    rank on ``device``'s type (``cuda`` unless the caller asks for another
    one). ``data * model`` must be the group's size. The layout and backend
    are the mesh's ``note``; a backend that fails to start raises."""
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = config.resolve(world)
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; the group "
                         f"has {world}")
    kind = torch.device("cuda" if device is None else device).type
    key = (data, model, kind)
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
    data_rank, model_rank = divmod(rank, model)
    model_group = None
    if model > 1:
        group = _subgroup([range(m, world, model) for m in range(model)], backend, rank)
        model_group = _subgroup([range(d * model, (d + 1) * model) for d in range(data)],
                                backend, rank)
    elif backend == "nccl" and world > 1:
        group = dist.new_group(backend="nccl")
    else:
        group = dist.group.WORLD
    layout = "data mesh" if model == 1 else f"{data} x {model} mesh"
    place = "" if model == 1 else f" (data {data_rank}, model {model_rank})"
    note = (f"{layout}: rank {rank} of {world}{place} on {dev}, collectives on {backend}"
            + (f" ({on_host} ranks share this host's {torch.cuda.device_count()} card(s))"
               if backend == "gloo" and kind == "cuda" else ""))
    mesh = _meshes[key] = Mesh(group, backend, data_rank, data, dev, model, model_rank,
                               model_group, note)
    return mesh


def writes() -> bool:
    """Whether this process writes run directories: every process but the
    ranks that ``spawn_ranks`` started."""
    return not _spawned


# ---------------------------------------------------------------- rows


def local_rows(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """The contiguous [lo, hi) rows of an ``n``-row global batch that this
    rank's data index owns: blocks of ceil(n / data) rows in data order, the
    last ones shorter or empty where ``data`` does not divide ``n``."""
    if mesh is None or mesh.data == 1:
        return 0, n
    per = -(-n // mesh.data)
    return min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)


def gather_rows(mesh: Optional[Mesh], x: torch.Tensor, n: int, dim: int = 0
                ) -> torch.Tensor:
    """Every data index's ``local_rows`` of an ``n``-row axis ``dim`` in
    global order, on every rank: each rank's rows in a zero-filled global
    buffer, summed over the data group. The sum is exact (a value plus
    zeros), and an all-reduce takes CUDA tensors on gloo, which its
    all-gather does not."""
    if mesh is None or mesh.data == 1:
        return x
    lo, hi = local_rows(mesh, n)
    shape = list(x.shape)
    shape[dim] = n
    buf = x.new_zeros(shape)
    buf.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(buf, group=mesh.group)
    return buf


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's ``obj``, in rank order (pickled through the CPU)."""
    out = [None] * mesh.data
    dist.all_gather_object(out, obj)
    return out


def all_reduce_min(mesh: Optional[Mesh], value: int) -> int:
    """The least of every rank's ``value``, over both axes: a choice all
    ranks must share."""
    if mesh is None or mesh.size == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64,
                     device=mesh.device if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def splits(mesh: Optional[Mesh]) -> bool:
    """Whether independent programs (seeds, GA candidates) split over the
    data axis: a data axis of several ranks and no model axis. Each rank
    then runs its ``local_rows`` of them, none on some ranks where they are
    fewer than the ranks. The JAX package shards them where ``data``
    divides their count and otherwise splits each one's batch over the data
    axis (eoe_tpu/training/vmapped_seeds.py:117-118,
    eoe_tpu/evolve/vmapped.py:163); a program here holds no collective, so
    an uneven split gives one process's numbers. Under a model axis every
    rank runs them all, as in the JAX package."""
    return mesh is not None and mesh.data > 1 and mesh.model == 1


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


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh):
    """Sum the gradients of ``params`` over the data axis as DDP does: each
    gradient times 1 / data, then summed over the data group, in one
    all-reduce of a flat buffer per dtype. The step of the resident epoch
    calls it in DDP's place after its backward; with no host
    synchronisation in it, a CUDA graph captures it on NCCL."""
    grads = [p.grad for p in params if p.grad is not None]
    for dtype in dict.fromkeys(g.dtype for g in grads):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same]).mul_(1.0 / mesh.data)
        dist.all_reduce(flat, group=mesh.group)
        for g, part in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(part.view_as(g))


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the data axis, on every rank. Its backward sums
    the ranks' gradients: each rank's loss is its share of the global loss,
    so the sum is the global loss's gradient of this rank's ``x``."""
    return _AllReduceSum.apply(x, mesh.group)


_active: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Inside the block, train-mode batch norm takes its statistics over the
    global batch of ``mesh`` (when it has more than one rank)."""
    global _active
    prev, _active = _active, (mesh if mesh is not None and mesh.data > 1 else None)
    try:
        yield
    finally:
        _active = prev


def active_mesh() -> Optional[Mesh]:
    return _active


# ---------------------------------------------------------------- the model axis

Split = Tuple[int, int]   # a parameter's split: (dim, blocks along dim)

# parameter-name suffix -> its split, the JAX package's _TP_RULES
# (eoe_tpu/parallel/mesh.py:164-171) on the port's names. nn.Linear.weight is
# (out, in): JAX's P(None, model) of an (in, out) kernel splits dim 0 here,
# P(model, None) dim 1. ``qkv``'s outputs are three blocks [q | k | v] and a
# rank takes its slice of each, i.e. its heads; JAX splits the 3D columns
# contiguously and lets XLA reshard, which computes the same function. The
# biases of ``attn_out`` and ``mlp_down`` stay whole, as in JAX: they are
# added once, after the reduction.
_TP_RULES: Sequence[Tuple[Tuple[str, str], Split]] = (
    (("mlp_up", "weight"), (0, 1)),
    (("mlp_up", "bias"), (0, 1)),
    (("mlp_down", "weight"), (1, 1)),
    (("qkv", "weight"), (0, 3)),
    (("qkv", "bias"), (0, 3)),
    (("attn_out", "weight"), (1, 1)),
)
_BY_HEADS = ("qkv", "attn_out")   # split by the heads of the module holding them


def param_shardings(mesh: Optional[Mesh], model: torch.nn.Module) -> Dict[str, Optional[Split]]:
    """Every parameter of ``model`` by name: its split over the model axis
    where a rule applies and the model size divides the split dimension, as
    JAX decides (``_spec_for_path``), else None (replicated). ``qkv`` and
    ``attn_out`` split only where the model size divides the heads of the
    module that holds them (``heads``): a head stays on one rank."""
    m = 1 if mesh is None else mesh.model
    out = {}
    for name, p in model.named_parameters():
        path, out[name] = tuple(name.split(".")), None
        for suffix, (dim, blocks) in _TP_RULES if m > 1 else ():
            if path[-2:] != suffix:
                continue
            if suffix[0] in _BY_HEADS:
                fits = model.get_submodule(".".join(path[:-2])).heads % m == 0
            else:
                fits = p.shape[dim] % (blocks * m) == 0
            out[name] = (dim, blocks) if fits else None
    return out


def shard_tensor(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of each of the ``blocks`` blocks of ``t`` along dim."""
    dim, blocks = split
    parts = t.unflatten(dim, (blocks, mesh.model, -1))
    return parts.select(dim + 1, mesh.model_rank).flatten(dim, dim + 1).contiguous()


def gather_tensor(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """The full tensor of every model rank's ``shard_tensor``: each rank's slices
    in a zero-filled buffer, its bytes summed over the model group (a byte
    plus zeros: exact, bit for bit, signed zeros included)."""
    dim, blocks = split
    shape = list(t.shape)
    full = t.new_zeros(shape[:dim] + [blocks, mesh.model, shape[dim] // blocks]
                       + shape[dim + 1:])
    full.select(dim + 1, mesh.model_rank).copy_(t.unflatten(dim, (blocks, -1)))
    dist.all_reduce(full.view(torch.uint8), group=mesh.model_group)
    return full.flatten(dim, dim + 2)


def shard_params(mesh: Mesh, state: dict, shardings: Dict[str, Optional[Split]]) -> dict:
    """This rank's shards of a full state dict (entries without a split, such
    as buffers, as they are)."""
    return {k: shard_tensor(v, shardings[k], mesh) if shardings.get(k) else v
            for k, v in state.items()}


def gather_params(mesh: Mesh, state: dict, shardings: Dict[str, Optional[Split]]) -> dict:
    """The full state dict of the model ranks' ``shard_params``; collective
    over the model group, in the order of ``state``."""
    return {k: gather_tensor(v, shardings[k], mesh) if shardings.get(k) else v
            for k, v in state.items()}


def shard_module(module: torch.nn.Module, mesh: Mesh, shardings: Dict[str, Optional[Split]]):
    """Make ``module`` hold this rank's shards: each split parameter takes its
    shard, and the module holding a split layer gets ``tp = mesh``, which
    its forward reads (``models.clip.model``)."""
    for name, split in shardings.items():
        if split is not None:
            p = module.get_parameter(name)
            p.data = shard_tensor(p.data, split, mesh)
            module.get_submodule(name.rsplit(".", 2)[0]).tp = mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The replicated input of a product split along its outputs: ``x`` as
    it is; its gradient is the sum of the model ranks' (each rank's product
    sees a part of the outputs)."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the model ranks of the partial products of a layer
    split along its inputs; its gradient reaches every rank's part as it
    is."""
    return _ReduceFromModel.apply(x, mesh.model_group)


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
