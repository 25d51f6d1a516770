"""CBAM's two gates and a BasicBlock's tail (the residual add and the ReLU)
as a few CUDA kernels, forward and backward, on channels-last activations,
and their plain PyTorch versions.

``gate_tail(o, residual, ...)`` is ``relu(cbam(o) + residual)`` for the
configuration WideResNet builds (avg and max channel pools, the spatial
gate), with ``o`` the block's bn2 output, NCHW in shape and NHWC in memory.
With ``cg = sigmoid(mlp(mean_hw o) + mlp(max_hw o))`` (n, c) and
``sg = sigmoid(bn(conv7x7([max_c x1, mean_c x1])))`` (n, 1, h, w):

    x1 = o * cg,    y = relu(x1 * sg + residual)

Forward, each kernel one pass over the activations (A: one such tensor):

- ``channel_pool`` (K1): per (image, channel), the mean and the max over the
  pixels with the max's tie count; a block per (image, band of pixels),
  then a small kernel merges the bands in order (1 A read);
- the shared MLP and its sigmoid in PyTorch, on (n, c);
- ``spatial_pool`` (K2): per pixel, the max over the channels of
  ``x1 = o * cg``, computed in registers and never stored, with its tie
  count, and the mean: the spatial gate's (n, 2, h, w) input (1 A read);
- the 7x7 conv, the one-channel BN and the sigmoid: the modules' own
  PyTorch ops, so that BN takes the global batch's statistics under a data
  mesh and each vmapped member's own;
- ``gate`` (K3): ``y`` (2 A read, 1 A written).

Backward, with ``g' = gy * [y > 0]`` (the residual's gradient):

- ``gate_bwd`` (B1): per pixel, ``g'`` (written), ``g' * sg``, the gradient
  of x1 through the tail (written), and ``sum_c g' * x1``, sg's (3 A read,
  2 A written);
- the spatial gate's backward in PyTorch: the pixel maps' gradients;
- ``channel_bwd`` (B2): per (image, channel), ``sum_hw gx1 * o``, cg's
  gradient, with ``gx1 = g' sg + gmax [x1 = max_c x1] / ties + gmean / c``
  recomputed in registers; two stages as K1 (2 A read);
- the MLP's backward in PyTorch (``channel_gate_bwd``, autograd's
  arithmetic written out);
- ``input_bwd`` (B3): ``go = gx1 cg + gmx [o = max_hw o] / ties + gavg / hw``,
  o's whole gradient, written once (2 A read, 1 A written).

That is 5 A forward and 10 A backward, where the chain of PyTorch ops it
replaces moves about 50. A tie of either max splits its gradient evenly, as
``torch.amax``'s backward and JAX's reduce-max JVP do. The kernels take fp32
or bf16 and accumulate in fp32; ``x1 = o * cg`` is formed in fp32 alike in
every kernel (no FMA contraction), so the backward's equality masks find
the forward's maxima exactly. Reductions run in two stages through scratch
from ``torch.empty``, with no float atomics: two runs give the same bits.

Two ``torch.autograd.Function``s carry it: ``_Pools`` (K1, the MLP, K2; its
backward B2, the MLP's, B3) and ``_Tail`` (K3; its backward B1). ``_Pools``
also returns ``x1``, the gated tensor in factored form: a view of ``o``
whose values ``_Tail`` reads together with ``cg``; ``_Tail`` returns x1's
gradient as the gradient of that view, so that it reaches ``_Pools``'s
backward, which writes o's gradient once (autograd would otherwise sum
three full-size gradients into it). Both have generated vmap rules, so the
MLP and the spatial gate run per member; under a ``torch.func`` transform
each kernel call inside them goes through ``_Call``, whose vmap rule folds
the members into the image axis, (K, n, ...) -> (K*n, ...), and launches
once: every kernel works on each image alone. On a CPU tensor the same Functions run the plain versions
(``*_ref``); on a CUDA tensor they launch the kernels of ``csrc/cbam.cu``
(built at first use, see ``_build``) or raise. ``launches`` and
``bwd_launches`` count the kernels launched by the forward and by the
backward (four each a block).
"""

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from eoe_tpu_torch.ops import _build

SOURCE = "cbam.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16     # the kernels read and write a pixel's channels in 16-byte pieces
THREADS = 256         # threads of every kernel's block
MAX_VECTORS = THREADS  # pieces of one pixel a pool block spreads over its threads
BLOCKS_PER_SM = 8     # the row kernels' and the pools' target of resident blocks

launches = 0          # kernels launched by the forward (K1's two, K2, K3)
bwd_launches = 0      # kernels launched by the backward (B1, B2's two, B3)


def fusable(channels: int, pool_types, spatial: bool) -> bool:
    """Whether a CBAM of this configuration can take the kernels: avg and max
    channel pools, the spatial gate, and channels that fill whole 16-byte
    pieces in either dtype and fit one pool block."""
    return (tuple(pool_types) == ("avg", "max") and spatial and channels % 8 == 0
            and channels // 4 <= MAX_VECTORS)


# ---------------------------------------------------------------- plain versions


def channel_pool_ref(o: torch.Tensor):
    """K1: (mean, max) over the pixels of each (image, channel) in o's dtype,
    and the max's tie count (fp32)."""
    of = o.float()
    mx = of.amax(dim=(2, 3))
    ties = (of == mx[:, :, None, None]).sum(dim=(2, 3)).float()
    return of.mean(dim=(2, 3)).to(o.dtype), mx.to(o.dtype), ties


def _x1(o: torch.Tensor, cg: torch.Tensor) -> torch.Tensor:
    return o.float() * cg[:, :, None, None]


def _pixels(t: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """A per-pixel map of any shape with n*h*w entries as (n, 1, h, w) fp32."""
    n, _, h, w = o.shape
    return t.reshape(n, 1, h, w).float()


def spatial_pool_ref(o: torch.Tensor, cg: torch.Tensor):
    """K2: the spatial gate's input (n, 2, h, w) in o's dtype, [max_c x1,
    mean_c x1] with ``x1 = o * cg`` in fp32, and the max (fp32) with its tie
    count, (n, h, w) each."""
    x1 = _x1(o, cg)
    cmax = x1.amax(dim=1)
    ties = (x1 == cmax[:, None]).sum(dim=1).float()
    return torch.stack([cmax, x1.mean(dim=1)], dim=1).to(o.dtype), cmax, ties


def gate_ref(o: torch.Tensor, cg: torch.Tensor, sg: torch.Tensor, r: torch.Tensor):
    """K3: ``relu(o * cg * sg + r)`` in fp32, in o's dtype; sg (n, h, w)."""
    return (torch.relu(_x1(o, cg) * _pixels(sg, o) + r.float()).to(o.dtype),)


def gate_bwd_ref(gy: torch.Tensor, y: torch.Tensor, o: torch.Tensor, cg: torch.Tensor,
                 sg: torch.Tensor):
    """B1: the residual's gradient ``g' = gy [y > 0]`` and x1's through the
    tail ``g' sg``, in o's dtype, and sg's ``sum_c g' x1`` (n, h, w), fp32."""
    g = torch.where(y > 0, gy, torch.zeros_like(gy)).float()
    return g.to(o.dtype), (g * _pixels(sg, o)).to(o.dtype), (g * _x1(o, cg)).sum(dim=1)


def _gx1(gx1: torch.Tensor, o: torch.Tensor, cg: torch.Tensor, gc: torch.Tensor,
         cmax: torch.Tensor, ties: torch.Tensor) -> torch.Tensor:
    """x1's whole gradient: the tail's, the channel max's split over its ties
    and the channel mean's."""
    x1 = _x1(o, cg)
    gc = gc.reshape(o.shape[0], 2, *o.shape[2:]).float()
    at_max = torch.where(x1 == _pixels(cmax, o), gc[:, :1] / _pixels(ties, o),
                         torch.zeros_like(x1))
    return gx1.float() + at_max + gc[:, 1:] / o.shape[1]


def channel_bwd_ref(gx1: torch.Tensor, o: torch.Tensor, cg: torch.Tensor, gc: torch.Tensor,
                    cmax: torch.Tensor, ties: torch.Tensor):
    """B2: cg's gradient ``sum_hw gx1 o`` (n, c), fp32; ``gc`` is the spatial
    gate input's gradient (n, 2, h, w)."""
    return ((_gx1(gx1, o, cg, gc, cmax, ties) * o.float()).sum(dim=(2, 3)),)


def input_bwd_ref(gx1: torch.Tensor, o: torch.Tensor, cg: torch.Tensor, gc: torch.Tensor,
                  cmax: torch.Tensor, ties: torch.Tensor, mx: torch.Tensor,
                  mx_ties: torch.Tensor, gmx: torch.Tensor, gavg: torch.Tensor):
    """B3: o's gradient, in o's dtype: through x1, through the max over the
    pixels (split over its ties) and through their mean; ``gmx``, ``gavg``
    (n, c) fp32."""
    of = o.float()
    at_max = torch.where(of == mx.float()[:, :, None, None], (gmx / mx_ties)[:, :, None, None],
                         torch.zeros_like(of))
    hw = o.shape[2] * o.shape[3]
    go = _gx1(gx1, o, cg, gc, cmax, ties) * cg[:, :, None, None] + at_max \
        + (gavg / hw)[:, :, None, None]
    return (go.to(o.dtype),)


# ---------------------------------------------------------------- geometry


class RowGeometry(NamedTuple):
    """The per-pixel kernels (K2, K3, B1, B3): ``lanes`` threads of a warp
    share a pixel's channels (a power of two up to 32), each taking every
    ``lanes``-th 16-byte piece; ``blocks`` of THREADS threads stride over
    the pixels."""
    lanes: int
    blocks: int


class PoolGeometry(NamedTuple):
    """The per-(image, channel) reductions (K1, B2): a block per image and
    band of ``band`` pixels, ``splits`` bands an image; ``lanes`` threads
    take a pixel's 16-byte pieces, ``rows`` pixels at a time."""
    lanes: int
    rows: int
    splits: int
    band: int


def _pieces(c: int, dtype: torch.dtype) -> int:
    return c * torch.empty((), dtype=dtype).element_size() // VECTOR_BYTES


def row_geometry(pixels: int, c: int, dtype: torch.dtype, sms: int) -> RowGeometry:
    pieces = _pieces(c, dtype)
    lanes = 1
    while lanes * 2 <= min(32, pieces):
        lanes *= 2
    per_block = THREADS // lanes
    return RowGeometry(lanes, max(1, min(-(-pixels // per_block), BLOCKS_PER_SM * sms)))


def pool_geometry(n: int, hw: int, c: int, dtype: torch.dtype, sms: int) -> PoolGeometry:
    lanes = _pieces(c, dtype)
    rows = THREADS // lanes
    # enough blocks to fill the card, each band at least 4 rows of threads deep
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // n), -(-hw // (4 * rows))))
    band = -(-hw // splits)
    return PoolGeometry(lanes, rows, -(-hw // band), band)


# ---------------------------------------------------------------- the kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    V, I = ctypes.c_void_p, ctypes.c_int
    pool = [I] * 4        # lanes, rows, splits, band
    row = [I, I]          # lanes, blocks
    head = [I, I, I, I]   # n, hw, c, dtype
    for name, args in (
            ("eoe_cbam_channel_pool", [V, V, V, V, V] + head + pool + [V]),
            ("eoe_cbam_spatial_pool", [V, V, V, V, V] + head + row + [V]),
            ("eoe_cbam_gate", [V, V, V, V, V] + head + row + [V]),
            ("eoe_cbam_gate_bwd", [V] * 8 + head + row + [V]),
            ("eoe_cbam_channel_bwd", [V] * 8 + head + pool + [V]),
            ("eoe_cbam_input_bwd", [V] * 11 + head + row + [V])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    lib.eoe_cuda_error_string.argtypes = [I]
    lib.eoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _activation(t: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the kernels read an activation: like's shape, dtype and card,
    NHWC in memory (a copy where it is not), 16-byte aligned."""
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"cbam: {name} must be {tuple(like.shape)} {like.dtype} on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"cbam reads {name} in 16-byte pieces; it is misaligned")
    return t


def _small(t: torch.Tensor, shape: Tuple[int, ...], o: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A per-image map or vector of ``shape`` in ``dtype``, contiguous and
    16-byte aligned (a copy where it is not)."""
    if t.numel() != torch.Size(shape).numel() or t.device != o.device:
        raise ValueError(f"cbam: expected {shape} on {o.device}, got {tuple(t.shape)} "
                         f"on {t.device}")
    t = t.to(dtype).reshape(shape).contiguous()
    return t.clone() if t.data_ptr() % VECTOR_BYTES else t


def _check_o(o: torch.Tensor) -> torch.Tensor:
    if not o.is_cuda:
        raise ValueError(f"cbam's kernels run on CUDA tensors, got {o.device}")
    if o.dtype not in _DTYPE_CODES:
        raise ValueError(f"cbam's kernels take float32 or bfloat16, got {o.dtype}")
    n, c, h, w = o.shape
    if c * o.element_size() % VECTOR_BYTES or _pieces(c, o.dtype) > MAX_VECTORS:
        raise ValueError(f"cbam's kernels take channels in whole 16-byte pieces, at most "
                         f"{MAX_VECTORS} of them; got {c} {o.dtype}")
    return _activation(o, o, "o")


def _launch(entry: str, o: torch.Tensor, geometry: tuple, *tensors: torch.Tensor) -> None:
    """Call C entry ``entry`` with the data of ``tensors``, o's sizes and
    dtype, the geometry, and the current stream."""
    n, c, h, w = o.shape
    lib = _library()
    with torch.cuda.device(o.device):  # the launcher uses the current device
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), n, h * w, c,
                                  _DTYPE_CODES[o.dtype], *geometry,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cbam {entry} launch failed: "
                           f"{lib.eoe_cuda_error_string(err).decode()}")


def _rows(o: torch.Tensor) -> RowGeometry:
    n, c, h, w = o.shape
    return row_geometry(n * h * w, c, o.dtype, _sms(o.device.index or 0))


def _pools(o: torch.Tensor) -> PoolGeometry:
    n, c, h, w = o.shape
    return pool_geometry(n, h * w, c, o.dtype, _sms(o.device.index or 0))


def _map(o: torch.Tensor, *lead: int, dtype=torch.float32) -> torch.Tensor:
    """A new (n, *lead, h, w) per-pixel map."""
    n, c, h, w = o.shape
    return torch.empty((n, *lead, h, w), dtype=dtype, device=o.device)


def channel_pool(o: torch.Tensor):
    global launches
    o = _check_o(o)
    n, c = o.shape[:2]
    geo = _pools(o)
    partial = torch.empty((n, geo.splits, 3, c), dtype=torch.float32, device=o.device)
    avg, mx = (torch.empty((n, c), dtype=o.dtype, device=o.device) for _ in range(2))
    ties = torch.empty((n, c), dtype=torch.float32, device=o.device)
    _launch("eoe_cbam_channel_pool", o, geo, o, partial, avg, mx, ties)
    launches += 2
    return avg, mx, ties


def spatial_pool(o: torch.Tensor, cg: torch.Tensor):
    global launches
    o = _check_o(o)
    n, c = o.shape[:2]
    cg = _small(cg, (n, c), o)
    compress, cmax, ties = _map(o, 2, dtype=o.dtype), _map(o), _map(o)
    _launch("eoe_cbam_spatial_pool", o, _rows(o), o, cg, compress, cmax, ties)
    launches += 1
    return compress, cmax, ties


def gate(o: torch.Tensor, cg: torch.Tensor, sg: torch.Tensor, r: torch.Tensor):
    global launches
    o = _check_o(o)
    n, c, h, w = o.shape
    cg, sg, r = _small(cg, (n, c), o), _small(sg, (n, h * w), o), _activation(r, o, "residual")
    y = torch.empty_like(o)
    _launch("eoe_cbam_gate", o, _rows(o), o, cg, sg, r, y)
    launches += 1
    return (y,)


def gate_bwd(gy: torch.Tensor, y: torch.Tensor, o: torch.Tensor, cg: torch.Tensor,
             sg: torch.Tensor):
    global bwd_launches
    o = _check_o(o)
    n, c, h, w = o.shape
    gy, y = _activation(gy, o, "gy"), _activation(y, o, "y")
    cg, sg = _small(cg, (n, c), o), _small(sg, (n, h * w), o)
    dr, gx1, dsg = torch.empty_like(o), torch.empty_like(o), _map(o)
    _launch("eoe_cbam_gate_bwd", o, _rows(o), gy, y, o, cg, sg, dr, gx1, dsg)
    bwd_launches += 1
    return dr, gx1, dsg


def channel_bwd(gx1: torch.Tensor, o: torch.Tensor, cg: torch.Tensor, gc: torch.Tensor,
                cmax: torch.Tensor, ties: torch.Tensor):
    global bwd_launches
    o = _check_o(o)
    n, c, h, w = o.shape
    gx1 = _activation(gx1, o, "gx1")
    cg, gc = _small(cg, (n, c), o), _small(gc, (n, 2, h * w), o, o.dtype)
    cmax, ties = _small(cmax, (n, h * w), o), _small(ties, (n, h * w), o)
    geo = _pools(o)
    partial = torch.empty((n, geo.splits, c), dtype=torch.float32, device=o.device)
    dcg = torch.empty((n, c), dtype=torch.float32, device=o.device)
    _launch("eoe_cbam_channel_bwd", o, geo, gx1, o, cg, gc, cmax, ties, partial, dcg)
    bwd_launches += 2
    return (dcg,)


def input_bwd(gx1: torch.Tensor, o: torch.Tensor, cg: torch.Tensor, gc: torch.Tensor,
              cmax: torch.Tensor, ties: torch.Tensor, mx: torch.Tensor, mx_ties: torch.Tensor,
              gmx: torch.Tensor, gavg: torch.Tensor):
    global bwd_launches
    o = _check_o(o)
    n, c, h, w = o.shape
    gx1 = _activation(gx1, o, "gx1")
    cg, gc = _small(cg, (n, c), o), _small(gc, (n, 2, h * w), o, o.dtype)
    cmax, ties = _small(cmax, (n, h * w), o), _small(ties, (n, h * w), o)
    mx, mx_ties = _small(mx, (n, c), o, o.dtype), _small(mx_ties, (n, c), o)
    gmx, gavg = _small(gmx, (n, c), o), _small(gavg, (n, c), o)
    go = torch.empty_like(o)
    _launch("eoe_cbam_input_bwd", o, _rows(o), gx1, o, cg, gc, cmax, ties, mx, mx_ties, gmx,
            gavg, go)
    bwd_launches += 1
    return (go,)


class Impl(NamedTuple):
    """The six functions, as kernels or as their plain versions."""
    channel_pool: Callable
    spatial_pool: Callable
    gate: Callable
    gate_bwd: Callable
    channel_bwd: Callable
    input_bwd: Callable


REF = Impl(channel_pool_ref, spatial_pool_ref, gate_ref, gate_bwd_ref, channel_bwd_ref,
           input_bwd_ref)
KERNELS = Impl(channel_pool, spatial_pool, gate, gate_bwd, channel_bwd, input_bwd)


# ---------------------------------------------------------------- autograd


def _fold(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """A vmapped argument with its member axis folded into the image axis:
    (K, n, ...) -> (K*n, ...); an unbatched one is broadcast first."""
    t = t.expand(size, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(size * t.shape[1], *t.shape[2:])


class _Call(torch.autograd.Function):
    """One of ``Impl``'s functions, outside autograd (the Functions below
    differentiate the chain). Under ``torch.func.vmap`` the rule folds the
    members into the image axis and calls it once; the rule calls the
    Function again, so that nested vmaps peel one level each."""

    @staticmethod
    def forward(fn, *tensors):
        return tuple(fn(*tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("cbam's kernels are differentiated by _Pools and _Tail")

    @staticmethod
    def vmap(info, in_dims, fn, *tensors):
        K = info.batch_size
        out = _Call.apply(fn, *(_fold(t, d, K) for t, d in zip(tensors, in_dims[1:])))
        return tuple(t.reshape(K, -1, *t.shape[1:]) for t in out), (0,) * len(out)


def _call(fn: Callable, *tensors: torch.Tensor):
    """``fn(*tensors)``, through ``_Call`` under a ``torch.func`` transform
    (its vmap rule folds the members), directly otherwise: a Function's
    apply costs host time that a step of eager blocks adds up."""
    if torch._C._are_functorch_transforms_active():
        return _Call.apply(fn, *tensors)
    return tuple(fn(*tensors))


def channel_gate(avg: torch.Tensor, mx: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``sigmoid(mlp(avg) + mlp(mx))`` in ``dt``, as ``ChannelGate`` computes
    it (its ``Dense`` layers cast input, weight and bias to ``dt``)."""
    def mlp(p):
        h = F.relu(F.linear(p.to(dt), w1.to(dt), b1.to(dt)))
        return F.linear(h, w2.to(dt), b2.to(dt))
    return torch.sigmoid(mlp(avg) + mlp(mx))


def channel_gate_bwd(avg, mx, w1, b1, w2, b2, dt, cg, dcg):
    """The gradients of ``channel_gate``'s six inputs from cg's (``cg`` its
    output), as autograd computes them: in ``dt``, each of the two pooled
    vectors' uses of a weight cast back to the weight's dtype and summed
    there, as ``ChannelGate``'s two calls of a ``Dense`` accumulate."""
    a, m, w1d, w2d = avg.to(dt), mx.to(dt), w1.to(dt), w2.to(dt)
    ha, hm = F.relu(F.linear(a, w1d, b1.to(dt))), F.relu(F.linear(m, w1d, b1.to(dt)))
    datt = torch.ops.aten.sigmoid_backward(dcg.to(dt), cg.to(dt))
    dh = datt @ w2d                                   # the same for both pools
    dza, dzm = dh * (ha > 0), dh * (hm > 0)

    def t(x):
        return x.transpose(-1, -2)

    def both(x, y, like):
        return x.to(like.dtype) + y.to(like.dtype)
    return (dza @ w1d, dzm @ w1d, both(t(dza) @ a, t(dzm) @ m, w1),
            both(dza.sum(-2), dzm.sum(-2), b1), both(t(datt) @ ha, t(datt) @ hm, w2),
            both(datt.sum(-2), datt.sum(-2), b2))


class _Pools(torch.autograd.Function):
    """K1, the MLP and K2: ``(compress, x1, cg)``, the spatial gate's input,
    the gated tensor in factored form (a view of ``o``; its values are
    ``o * cg``) and the channel gate (fp32, no gradient), then what the
    backward reads. The backward takes the gradients of compress and x1 and
    returns o's, written once, and the MLP's parameters'."""

    generate_vmap_rule = True

    @staticmethod
    def forward(o, w1, b1, w2, b2, dt, impl):
        avg, mx, mx_ties = _call(impl.channel_pool, o)
        cg = channel_gate(avg, mx, w1, b1, w2, b2, dt).float()
        compress, cmax, ties = _call(impl.spatial_pool, o, cg)
        return compress, o.view_as(o), cg, avg, mx, mx_ties, cmax, ties

    @staticmethod
    def setup_context(ctx, inputs, output):
        o, w1, b1, w2, b2, dt, impl = inputs
        _, _, cg, avg, mx, mx_ties, cmax, ties = output
        ctx.save_for_backward(o, w1, b1, w2, b2, cg, avg, mx, mx_ties, cmax, ties)
        ctx.mark_non_differentiable(*output[2:])
        ctx.dt, ctx.impl = dt, impl

    @staticmethod
    def backward(ctx, g_compress, g_x1, *_):
        o, w1, b1, w2, b2, cg, avg, mx, mx_ties, cmax, ties = ctx.saved_tensors
        impl, dt = ctx.impl, ctx.dt
        (dcg,) = _call(impl.channel_bwd, g_x1, o, cg, g_compress, cmax, ties)
        g_avg, g_mx, dw1, db1, dw2, db2 = channel_gate_bwd(avg, mx, w1, b1, w2, b2, dt, cg, dcg)
        (go,) = _call(impl.input_bwd, g_x1, o, cg, g_compress, cmax, ties, mx, mx_ties,
                      g_mx.float(), g_avg.float())
        return go, dw1, db1, dw2, db2, None, None


class _Tail(torch.autograd.Function):
    """K3: ``y = relu(x1 * sg + r)`` from x1 in factored form (``x1``, a view
    of o, and ``cg``); sg (n, 1, h, w). The backward (B1) returns x1's
    gradient through the tail, sg's and the residual's; cg takes its
    gradient through x1, in ``_Pools``'s backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x1, cg, sg, r, impl):
        return _call(impl.gate, x1, cg, sg.reshape(sg.shape[0], -1).float(), r)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x1, cg, sg, r, impl = inputs
        ctx.save_for_backward(x1, cg, sg, output)
        ctx.impl = impl

    @staticmethod
    def backward(ctx, gy):
        x1, cg, sg, y = ctx.saved_tensors
        dr, g_x1, dsg = _call(ctx.impl.gate_bwd, gy, y, x1, cg,
                              sg.reshape(sg.shape[0], -1).float())
        return g_x1, None, dsg.reshape(sg.shape).to(sg.dtype), dr, None


def gate_tail(o: torch.Tensor, residual: torch.Tensor, mlp: Tuple[torch.Tensor, ...],
              dt: torch.dtype, spatial: Callable[[torch.Tensor], torch.Tensor],
              impl: Impl = None) -> torch.Tensor:
    """``relu(cbam(o) + residual)``: ``mlp`` the shared MLP's (w1, b1, w2,
    b2), ``dt`` its compute dtype, ``spatial`` the spatial gate's conv and BN
    (compress -> its logits). ``impl`` defaults to the kernels on a CUDA
    tensor and to the plain versions elsewhere."""
    if impl is None:
        impl = KERNELS if o.is_cuda else REF
    compress, x1, cg = _Pools.apply(o, *mlp, dt, impl)[:3]
    return _Tail.apply(x1, cg, torch.sigmoid(spatial(compress)), residual, impl)
