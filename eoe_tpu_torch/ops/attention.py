"""Attention for the CLIP encoders: the CUDA kernels and their plain
PyTorch versions.

``fused_qkv_attention`` is the port of eoe_tpu/ops/attention.py's
``fused_qkv_attention`` with its custom VJP: the forward is the Pallas kernel
``_fwd_compute``, the backward ``_bwd_compute``. It consumes the
un-transposed joint projection ``(n, s, 3*H*d)`` and returns ``(n, s, H*d)``.
It is a ``torch.autograd.Function`` that saves only ``qkv``, as ``_fused_fwd``
saves ``qkv_p``. On a CUDA tensor its forward and backward launch the
hand-written kernels in ``csrc/fused_qkv_attention.cu`` (built at first use,
see ``_build``) or raise; on a CPU tensor they compute the same functions
with the plain versions ``fused_qkv_attention_fwd_ref`` and
``fused_qkv_attention_bwd_ref``. In bf16 the kernels run on the tensor cores,
in fp32 on register tiles of the CUDA cores; since they copy rows in 16-byte
pieces, ``qkv`` and ``dout`` must be 16-byte aligned, pointer and row pitch,
in either dtype (or they raise). ``fused_qkv_attention_ref`` is the plain
pair as one differentiable function, on any device. With ``GROUP_GRID`` set
(``EOE_TPU_ATTN_GROUP_GRID=1``, as in the JAX package) the kernels run on the
lane-group grid of ``_fwd_group_compute`` and ``_bwd_group_compute``.

Under ``torch.func.vmap`` (the vmapped seed and candidate engines) the
forward and the backward each launch their kernel once on the members
folded into the image axis, (K, n, s, F) -> (K*n, s, F), as the JAX
package's ``_vmappable_call`` does: each image is attended on its own, so
this is exact.

``flash_attention`` is the port of the JAX package's opt-in
``flash_attention`` (``CLIP(attention_fn=flash_attention)``): its forward is
the Pallas kernel ``_kernel``, here ``csrc/flash_attention.cu`` on a CUDA
tensor and ``flash_attention_ref`` on a CPU tensor; its backward differentiates
``default_attention``, as the JAX package's does. The kernel's launcher picks
its variant by dtype, head dim and alignment: the tensor cores for bf16, the
fp32 register tiles for fp32, each where d <= 128 fills whole 16-byte chunks
and every row of q, k, v starts on 16 bytes; the CUDA-core design otherwise.
"""

import ctypes
import functools
import os
from typing import Optional

import torch

from eoe_tpu_torch.ops import _build

LANE = 128      # the JAX kernel's lane group; heads must tile it evenly
MAX_SEQ = 128   # the CUDA kernels' longest sequence: one tile covers it
# The JAX package's row budget of one grid cell (eoe_tpu/ops/attention.py:127),
# read at import as there: the gate takes a sequence only when its 16-row
# padding fits it.
MAX_R = int(os.environ.get("EOE_TPU_ATTN_MAX_R", "128"))
SOURCE = "fused_qkv_attention.cu"
FLASH_SOURCE = "flash_attention.cu"
MAX_SINGLE_BLOCK = 1024   # flash_attention's longest sequence; longer ones run default_attention
FLASH_TENSOR_CORES, FLASH_REGISTER_TILES = 1, 2   # the variants the flash launcher reports
BWD_RESIDENT, BWD_RECOMPUTE = 1, 2   # the fp32 backward designs its launcher reports
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The JAX package's switch to the lane-group grid (eoe_tpu/ops/attention.py:412),
# read at call time: tests and callers may set the module global.
GROUP_GRID = os.environ.get("EOE_TPU_ATTN_GROUP_GRID", "0") == "1"


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(n, heads, s, d) scaled dot-product attention; logits and softmax in
    fp32, probabilities cast to v's dtype (eoe_tpu/models/clip/model.py:83).
    ``default_attention.cuda_calls`` counts its calls on CUDA tensors."""
    if q.is_cuda:
        default_attention.cuda_calls += 1
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", probs, v)


default_attention.cuda_calls = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_fused_shape(heads: int, d: int, s: int):
    """Reject what the JAX package's fused kernel rejects
    (eoe_tpu/ops/attention.py:592): head dims other than 64 and 128, head
    counts that do not tile a 128-lane group, sequences whose 16-row padding
    exceeds ``MAX_R``. The gate also keeps sequences over ``MAX_SEQ`` from
    the CUDA kernels, whose C entry points refuse them."""
    per = LANE // d if d in (64, 128) else 0
    if per == 0 or heads % per != 0:
        raise ValueError(
            f"fused_qkv_attention requires d in (64, 128) and "
            f"heads%(LANE//d)==0; got heads={heads}, d={d} "
            f"(use fused_qkv_ok() to gate)")
    if _round_up(s, 16) > MAX_R:
        raise ValueError(f"sequence {s} exceeds the single-cell budget MAX_R={MAX_R}")


def fused_qkv_ok(n: int, s: int, heads: int, d: int,
                 sample: Optional[torch.Tensor] = None) -> bool:
    """Whether the CUDA kernels apply: ``EOE_TPU_FUSED_ATTN`` is unset or
    "1" (read at call time, as the JAX gate reads it), ``sample`` (the
    projection) lies on a CUDA device and the shape passes the JAX gate
    (``_round_up(s, 16) <= MAX_R``) and fits the kernels (``s <= MAX_SEQ``).
    The dtype is not consulted: on the card a dtype the kernel does not take raises in
    ``fused_qkv_attention`` rather than running the plain version."""
    if os.environ.get("EOE_TPU_FUSED_ATTN", "1") != "1":
        return False
    if sample is None or not sample.is_cuda:
        return False
    aligned = (d == 64 and heads % 2 == 0) or d == 128
    return aligned and _round_up(s, 16) <= MAX_R and s <= MAX_SEQ and n >= 1


def _split_heads(qkv: torch.Tensor, heads: int):
    n, s, F = qkv.shape
    d = F // 3 // heads
    return qkv.reshape(n, s, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)  # (n, h, s, d)


def _probs_f32(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 attention probabilities as ``_fwd_group_math`` computes them: for
    d=64, q is pre-scaled by 2^-3 in the input dtype; for d=128 the fp32
    logits are scaled. Masked logits get -1e30."""
    d, s = q.shape[-1], q.shape[-2]
    scale = d ** -0.5
    if d == 64:
        logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(future, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(dim=-1, keepdim=True)


def fused_qkv_attention_fwd_ref(qkv: torch.Tensor, heads: int,
                                causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, with the numerics of
    ``_fwd_group_math`` (eoe_tpu/ops/attention.py:184): the fp32 softmax of
    ``_probs_f32``, P rounded to the input dtype, P.V accumulated in fp32."""
    n, s, F = qkv.shape
    D = F // 3
    _check_fused_shape(heads, D // heads, s)
    q, k, v = _split_heads(qkv, heads)
    p = _probs_f32(q, k, causal).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # (n, h, s, d)
    return out.transpose(1, 2).reshape(n, s, D)


def fused_qkv_attention_bwd_ref(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                                causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: ``d(qkv)`` of shape
    ``(n, s, 3*H*d)``, packed [dq | dk | dv], with the numerics of
    ``_bwd_group_math`` (eoe_tpu/ops/attention.py:234), not those of autograd
    through the plain forward: P is recomputed in fp32; dv = round(P).dout;
    dp = dout.v^T in fp32; dS = (dp - rowsum(dp*P)) * P with the fp32 P,
    rounded to the input dtype before dq = dS.k and dk = dS^T.q. The d^-1/2
    scale sits inside dS for d=128 and on dq and dk after the products for
    d=64, as the JAX kernel puts it."""
    n, s, F = qkv.shape
    D = F // 3
    d = D // heads
    _check_fused_shape(heads, d, s)
    scale = d ** -0.5
    q, k, v = _split_heads(qkv, heads)
    g = dout.reshape(n, s, heads, d).transpose(1, 2).float()
    p = _probs_f32(q, k, causal)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = (dp - (dp * p).sum(dim=-1, keepdim=True)) * p
    if d == 128:
        ds = ds * scale
    ds = ds.to(qkv.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    if d == 64:
        dq, dk = dq * scale, dk * scale
    dqkv = torch.stack([dq, dk, dv])                      # (3, n, h, s, d)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, s, F).to(qkv.dtype)


def _fold(t: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """A vmapped argument with its member axis first and folded into the
    image axis: (K, n, ...) -> (K*n, ...). An unbatched one is broadcast to
    every member first."""
    t = t.expand(size, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(size * t.shape[1], *t.shape[2:])


class _QkvAttention(torch.autograd.Function):
    """The forward function; saves only ``qkv``. Its backward is
    ``_QkvAttentionBwd``, a Function of its own, so that ``torch.func``
    transforms reach the backward kernel through its vmap rule. Under
    ``torch.func.vmap`` the rule folds the members into the image axis,
    (K, n, s, F) -> (K*n, s, F), and launches the kernel once: each image is
    attended on its own, so this is exact (the JAX package's
    ``_vmappable_call``). The rule calls the Function again, so that nested
    vmaps peel one level each."""

    @staticmethod
    def forward(qkv, heads, causal, fwd, bwd):
        return fwd(qkv, heads, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qkv, heads, causal, _fwd, bwd = inputs
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal, ctx.bwd = heads, causal, bwd

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return _QkvAttentionBwd.apply(qkv, dout, ctx.heads, ctx.causal, ctx.bwd), \
            None, None, None, None

    @staticmethod
    def vmap(info, in_dims, qkv, heads, causal, fwd, bwd):
        K = info.batch_size
        out = _QkvAttention.apply(_fold(qkv, in_dims[0], K), heads, causal, fwd, bwd)
        return out.reshape(K, -1, *out.shape[1:]), 0


class _QkvAttentionBwd(torch.autograd.Function):
    """The backward function: packed d(qkv) from ``qkv`` and ``dout``, with
    the same folding vmap rule as the forward. Not differentiable again."""

    @staticmethod
    def forward(qkv, dout, heads, causal, bwd):
        return bwd(qkv, dout.contiguous(), heads, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _g):
        raise RuntimeError("fused_qkv_attention is differentiable once")

    @staticmethod
    def vmap(info, in_dims, qkv, dout, heads, causal, bwd):
        K = info.batch_size
        out = _QkvAttentionBwd.apply(_fold(qkv, in_dims[0], K), _fold(dout, in_dims[1], K),
                                     heads, causal, bwd)
        return out.reshape(K, -1, *out.shape[1:]), 0


def fused_qkv_attention_ref(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """The kernels' plain versions as one differentiable function, on any
    device: ``fused_qkv_attention_fwd_ref`` forward,
    ``fused_qkv_attention_bwd_ref`` backward. ``CLIP(qkv_attention=...)``
    takes it as a like-for-like control for the kernels on the card."""
    return _QkvAttention.apply(qkv, heads, causal, fused_qkv_attention_fwd_ref,
                               fused_qkv_attention_bwd_ref)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd_args = [P, P, I, I, I, I, I, I, ctypes.c_float, P]
    bwd_args = [P, P, P] + fwd_args[2:] + [ctypes.POINTER(I)]
    for name, args in (("eoe_fused_qkv_attention_fwd", fwd_args),
                       ("eoe_fused_qkv_attention_group_fwd", fwd_args),
                       ("eoe_fused_qkv_attention_bwd", bwd_args),
                       ("eoe_fused_qkv_attention_group_bwd", bwd_args)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = I
    lib.eoe_cuda_error_string.argtypes = [I]
    lib.eoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _flash_library() -> ctypes.CDLL:
    lib = _build.load(FLASH_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.eoe_flash_attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I,
                                            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P,
                                            ctypes.POINTER(I)]
    lib.eoe_flash_attention_fwd.restype = I
    lib.eoe_long_attention_fwd.argtypes = [P, P, P, I, I, I, I, ctypes.c_float, P]
    lib.eoe_long_attention_fwd.restype = I
    lib.eoe_long_attention_bwd.argtypes = [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P]
    lib.eoe_long_attention_bwd.restype = I
    lib.eoe_cuda_error_string.argtypes = [I]
    lib.eoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_card_tensor(t: torch.Tensor, name: str):
    """What the kernels take: a contiguous fp32 or bf16 CUDA tensor whose data
    and row pitch are multiples of 16 bytes, since the kernels copy its rows
    in 16-byte pieces."""
    if not t.is_cuda:
        raise ValueError(f"fused_qkv_attention runs on CUDA or CPU tensors, got {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_qkv_attention takes float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"fused_qkv_attention needs a contiguous {name}")
    if t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16:
        raise ValueError(f"fused_qkv_attention reads {name} in 16-byte pieces; it is misaligned")


def _raise_on(lib: ctypes.CDLL, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.eoe_cuda_error_string(err).decode()}")


def _launch_fwd(qkv: torch.Tensor, heads: int, causal: bool, entry: str) -> torch.Tensor:
    n, s, F = qkv.shape
    D = F // 3
    d = D // heads
    _check_card_tensor(qkv, "qkv")
    out = torch.empty((n, s, D), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):  # the launcher uses the current device
        err = getattr(lib, entry)(
            qkv.data_ptr(), out.data_ptr(), n, s, heads, d, _DTYPE_CODES[qkv.dtype],
            int(causal), d ** -0.5, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "fused_qkv_attention")
    return out


def _fwd_kernel(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    out = _launch_fwd(qkv, heads, causal, "eoe_fused_qkv_attention_fwd")
    fused_qkv_attention.launches += 1
    return out


def _group_fwd_kernel(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """The forward on the lane-group grid (``_fwd_group_compute``)."""
    out = _launch_fwd(qkv, heads, causal, "eoe_fused_qkv_attention_group_fwd")
    fused_qkv_attention.group_launches += 1
    return out


def _check_bwd_args(qkv: torch.Tensor, dout: torch.Tensor):
    n, s, F = qkv.shape
    D = F // 3
    _check_card_tensor(qkv, "qkv")
    _check_card_tensor(dout, "dout")
    if dout.shape != (n, s, D) or dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise ValueError(f"dout must be {(n, s, D)} {qkv.dtype} on {qkv.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")


def _launch_bwd(qkv: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool,
                entry: str) -> torch.Tensor:
    n, s, F = qkv.shape
    d = F // 3 // heads
    _check_bwd_args(qkv, dout)
    dqkv = torch.empty_like(qkv)
    lib = _library()
    design = ctypes.c_int(-1)
    with torch.cuda.device(qkv.device):
        err = getattr(lib, entry)(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), n, s, heads, d,
            _DTYPE_CODES[qkv.dtype], int(causal), d ** -0.5,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(design))
    _raise_on(lib, err, "fused_qkv_attention backward")
    if design.value == BWD_RESIDENT:
        fused_qkv_attention.resident_bwd_launches += 1
    elif design.value == BWD_RECOMPUTE:
        fused_qkv_attention.recompute_bwd_launches += 1
    return dqkv


def _bwd_kernel(qkv: torch.Tensor, dout: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    dqkv = _launch_bwd(qkv, dout, heads, causal, "eoe_fused_qkv_attention_bwd")
    fused_qkv_attention.bwd_launches += 1
    return dqkv


def _group_bwd_kernel(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                      causal: bool) -> torch.Tensor:
    """The backward on the lane-group grid (``_bwd_group_compute``): the
    kernel writes dq, dk and dv into the three column blocks of one packed
    d(qkv), which is ``_group_grid_call``'s concatenation
    (eoe_tpu/ops/attention.py:395)."""
    dqkv = _launch_bwd(qkv, dout, heads, causal, "eoe_fused_qkv_attention_group_bwd")
    fused_qkv_attention.group_bwd_launches += 1
    return dqkv


def fused_qkv_attention(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Multi-head self-attention fused over the concatenated projection,
    differentiable in ``qkv``.

    ``qkv``: (n, s, 3*D), features ordered [q | k | v] with heads contiguous
    inside each. Returns (n, s, D), heads concatenated, un-transposed.
    ``causal`` applies the upper-triangular mask of the CLIP text encoder.
    On a CUDA tensor the forward and the backward launch their kernels, on
    the lane-group grid when ``GROUP_GRID`` is set and ``heads*d`` tiles the
    128-lane groups (as ``_fused_call`` chooses); on a CPU tensor they run the
    plain versions, which compute the same function on either grid.
    ``fused_qkv_attention.launches`` and ``.bwd_launches`` count the launches
    of the forward and backward kernels on the monolithic grid,
    ``.group_launches`` and ``.group_bwd_launches`` on the group grid;
    ``.resident_bwd_launches`` and ``.recompute_bwd_launches`` count the fp32
    backward's launches on either grid by the design its launcher took (all
    tiles resident, or P and dS recomputed); bf16 takes the tensor cores."""
    n, s, F = qkv.shape
    d = F // 3 // heads
    _check_fused_shape(heads, d, s)
    if qkv.device.type == "cpu":
        return _QkvAttention.apply(qkv, heads, causal, fused_qkv_attention_fwd_ref,
                                   fused_qkv_attention_bwd_ref)
    if GROUP_GRID and (heads * d) % LANE == 0:
        return _QkvAttention.apply(qkv, heads, causal, _group_fwd_kernel, _group_bwd_kernel)
    return _QkvAttention.apply(qkv, heads, causal, _fwd_kernel, _bwd_kernel)


fused_qkv_attention.launches = 0
fused_qkv_attention.bwd_launches = 0
fused_qkv_attention.group_launches = 0
fused_qkv_attention.group_bwd_launches = 0
fused_qkv_attention.resident_bwd_launches = 0
fused_qkv_attention.recompute_bwd_launches = 0


# ---------------------------------------------------------------- flash attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the flash kernel, with ``_kernel``'s numerics
    (eoe_tpu/ops/attention.py:41): q and k in fp32, the logits scaled after
    the product, then the fp32 mask added; an fp32 softmax normalised before P
    is rounded to v's dtype; P.V accumulated in fp32 and cast to q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask.float()
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Launches the flash kernel. q, k and v may be strided views (the
    head-split joint projection) as long as d is contiguous; the output is
    (n, h, s, d) laid out in (n, s, h, d) memory, so that the caller's
    transpose back to (n, s, h*d) needs no copy. Counts the launch, and the
    variant the launcher took."""
    n, h, s, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                             f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention needs the head dim of {name} contiguous")
    if mask is not None:
        if mask.shape != (s, s) or mask.device != q.device or not mask.is_floating_point():
            raise ValueError(f"flash_attention: the mask must be a float ({s}, {s}) tensor on "
                             f"{q.device}, got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty((n, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _flash_library()
    variant = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = lib.eoe_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), n, h, s, d, _DTYPE_CODES[q.dtype], strides, d ** -0.5,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(variant))
    _raise_on(lib, err, "flash_attention")
    flash_attention.launches += 1
    if variant.value == FLASH_TENSOR_CORES:
        flash_attention.tc_launches += 1
    elif variant.value == FLASH_REGISTER_TILES:
        flash_attention.tile_launches += 1
    return out


def _default_attention_vjp(q, k, v, mask, g):
    """d(q, k, v) of ``default_attention`` with the mask, through
    ``torch.func.vjp``, which also runs under ``torch.func`` transforms."""
    _, vjp = torch.func.vjp(lambda q, k, v: default_attention(q, k, v, mask), q, k, v)
    return vjp(g)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel (the plain version on CPU tensors).
    Backward: the vjp of ``default_attention`` with the mask, as the JAX
    package's ``_bwd`` takes ``jax.vjp`` of it (attention.py:646-650). Under
    ``torch.func.vmap`` the rule folds the members of q, k and v into the
    image axis and launches the kernel once with the shared mask, as
    ``pallas_call`` batches the JAX kernel; a mask that differs per member
    is refused."""

    @staticmethod
    def forward(q, k, v, mask, fwd):
        return fwd(q, k, v, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mask, _fwd = inputs
        ctx.save_for_backward(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return (*_default_attention_vjp(q, k, v, mask, g), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask, fwd):
        if in_dims[3] is not None:
            raise ValueError("flash_attention takes one mask for every vmapped member")
        K = info.batch_size
        folded = (_fold(t, d, K) for t, d in zip((q, k, v), in_dims))
        out = _FlashAttention.apply(*folded, mask, fwd)
        return out.reshape(K, -1, *out.shape[1:]), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for :func:`default_attention`: (n, heads, S, d) scaled
    dot-product attention with an optional additive (S, S) mask,
    differentiable in q, k and v, for any head dim. Above
    ``MAX_SINGLE_BLOCK`` it is ``default_attention``, as in the JAX package.
    ``flash_attention.launches`` counts kernel launches, ``.tc_launches`` those
    of the tensor-core variant and ``.tile_launches`` those of the fp32
    register tiles; the rest took the CUDA-core variant."""
    if q.shape[2] > MAX_SINGLE_BLOCK:
        return default_attention(q, k, v, mask)
    return _FlashAttention.apply(q, k, v, mask,
                                 flash_attention_ref if q.device.type == "cpu" else _flash_kernel)


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.tile_launches = 0


# ---------------------------------------------------------------- long attention


def long_qkv_ok(n: int, s: int, heads: int, d: int, sample: Optional[torch.Tensor] = None,
                masked: bool = False) -> bool:
    """Whether the long attention pair applies on the normal path: the fused
    kernels' switch ``EOE_TPU_FUSED_ATTN`` is on, no mask, a bf16
    projection (``sample``) on a CUDA device, ``MAX_SEQ < s <=
    MAX_SINGLE_BLOCK`` and d in (64, 128). fp32 keeps ``default_attention``."""
    if os.environ.get("EOE_TPU_FUSED_ATTN", "1") != "1" or masked:
        return False
    if sample is None or not sample.is_cuda or sample.dtype != torch.bfloat16:
        return False
    return n >= 1 and heads >= 1 and MAX_SEQ < s <= MAX_SINGLE_BLOCK and d in (64, 128)


def _long_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The flash kernel's logits: q and k in fp32, scaled after the product."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5


def long_qkv_attention_fwd_ref(qkv: torch.Tensor, heads: int):
    """Plain PyTorch version of the long attention's forward, with the flash
    kernel's numerics (``flash_attention_ref``): the output (n, s, H*d) and
    each row's fp32 max and sum of exp, (n, H, s, 2)."""
    n, s, F = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    logits = _long_logits(q, k)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(n, s, F // 3), torch.cat([m, l], dim=-1)


def long_qkv_attention_bwd_ref(qkv: torch.Tensor, out: torch.Tensor, stats: torch.Tensor,
                               dout: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the long attention's backward kernels, in
    the FlashAttention-2 order: P recomputed from the saved max m and sum l
    as exp(x - m) * (1 / l) and rounded to the input dtype for
    dv = round(P)^T.dout; dp = dout.v^T; dS = P * (dp - delta) with the fp32
    P and delta = rowsum(dout * out) in fp32, rounded to the input dtype for
    dq = dS.k * d^-1/2 and dk = dS^T.q * d^-1/2. Returns d(qkv) packed
    [dq | dk | dv] as the projection."""
    n, s, F = qkv.shape
    D = F // 3
    d = D // heads
    scale = d ** -0.5
    q, k, v = _split_heads(qkv, heads)
    g = dout.reshape(n, s, heads, d).transpose(1, 2).float()
    o = out.reshape(n, s, heads, d).transpose(1, 2).float()
    p = torch.exp(_long_logits(q, k) - stats[..., :1]) * (1.0 / stats[..., 1:])
    delta = (g * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(qkv.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dqkv = torch.stack([dq, dk, dv])                      # (3, n, h, s, d)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, s, F).to(qkv.dtype)


class _LongAttention(torch.autograd.Function):
    """The forward function: returns the output and the rows' statistics
    (not differentiable) and saves ``qkv``, the output and the statistics,
    nothing else. Its backward is ``_LongAttentionBwd``, a Function of its
    own, so that ``torch.func`` transforms reach the backward kernels
    through its vmap rule. Both rules fold the vmapped members into the
    image axis and launch once, as ``_QkvAttention``'s do."""

    @staticmethod
    def forward(qkv, heads, fwd, bwd):
        return fwd(qkv, heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qkv, heads, _fwd, bwd = inputs
        out, stats = output
        ctx.mark_non_differentiable(stats)
        ctx.save_for_backward(qkv, out, stats)
        ctx.heads, ctx.bwd = heads, bwd

    @staticmethod
    def backward(ctx, dout, _dstats):
        qkv, out, stats = ctx.saved_tensors
        return _LongAttentionBwd.apply(qkv, out, stats, dout, ctx.heads, ctx.bwd), None, None, None

    @staticmethod
    def vmap(info, in_dims, qkv, heads, fwd, bwd):
        K = info.batch_size
        out, stats = _LongAttention.apply(_fold(qkv, in_dims[0], K), heads, fwd, bwd)
        return ((out.reshape(K, -1, *out.shape[1:]), stats.reshape(K, -1, *stats.shape[1:])),
                (0, 0))


class _LongAttentionBwd(torch.autograd.Function):
    """The backward function: d(qkv) from ``qkv``, the output, the
    statistics and ``dout``, with the same folding vmap rule. Not
    differentiable again."""

    @staticmethod
    def forward(qkv, out, stats, dout, heads, bwd):
        return bwd(qkv, out, stats, dout.contiguous(), heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _g):
        raise RuntimeError("long_qkv_attention is differentiable once")

    @staticmethod
    def vmap(info, in_dims, qkv, out, stats, dout, heads, bwd):
        K = info.batch_size
        folded = (_fold(t, d, K) for t, d in zip((qkv, out, stats, dout), in_dims))
        got = _LongAttentionBwd.apply(*folded, heads, bwd)
        return got.reshape(K, -1, *got.shape[1:]), 0


def _long_fwd_kernel(qkv: torch.Tensor, heads: int):
    n, s, F = qkv.shape
    d = F // 3 // heads
    _check_card_tensor(qkv, "qkv")
    out = torch.empty((n, s, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((n, heads, s, 2), dtype=torch.float32, device=qkv.device)
    lib = _flash_library()
    with torch.cuda.device(qkv.device):
        err = lib.eoe_long_attention_fwd(qkv.data_ptr(), out.data_ptr(), stats.data_ptr(), n,
                                         heads, s, d, d ** -0.5,
                                         torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "long_qkv_attention")
    long_qkv_attention.launches += 1
    return out, stats


def _long_bwd_kernel(qkv: torch.Tensor, out: torch.Tensor, stats: torch.Tensor,
                     dout: torch.Tensor, heads: int) -> torch.Tensor:
    n, s, F = qkv.shape
    d = F // 3 // heads
    _check_bwd_args(qkv, dout)
    _check_card_tensor(out, "out")
    if out.shape != dout.shape or stats.shape != (n, heads, s, 2) \
            or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"long_qkv_attention backward: out {tuple(out.shape)} and stats "
                         f"{tuple(stats.shape)} {stats.dtype} do not match qkv {tuple(qkv.shape)}")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((n, heads, s), dtype=torch.float32, device=qkv.device)
    lib = _flash_library()
    with torch.cuda.device(qkv.device):
        err = lib.eoe_long_attention_bwd(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                         stats.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), n,
                                         heads, s, d, d ** -0.5,
                                         torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "long_qkv_attention backward")
    long_qkv_attention.bwd_launches += 1
    return dqkv


def long_qkv_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head self-attention without a mask over the joint projection
    ``qkv`` (n, s, 3*H*d) for ``MAX_SEQ < s <= MAX_SINGLE_BLOCK`` and d in
    (64, 128), differentiable in ``qkv``; returns (n, s, H*d) as
    ``fused_qkv_attention`` does. The forward is the flash kernel's
    tensor-core stream (``flash_attention``'s numerics: P normalised before
    it is rounded), which also writes each row's max and sum of exp; the
    backward is its own pair of kernels (``csrc/flash_attention.cu``),
    which recompute P from them; it saves ``qkv``, the output and the
    statistics alone. On the card it takes bf16 only; on a CPU tensor (any
    float dtype) the plain versions ``long_qkv_attention_fwd_ref`` and
    ``long_qkv_attention_bwd_ref`` run. ``long_qkv_attention.launches`` and
    ``.bwd_launches`` count the forward's and the backward's launches (the
    backward's two kernels count as one)."""
    n, s, F = qkv.shape
    d = F // 3 // heads
    if d not in (64, 128) or 3 * heads * d != F or not MAX_SEQ < s <= MAX_SINGLE_BLOCK:
        raise ValueError(f"long_qkv_attention takes d in (64, 128) and {MAX_SEQ} < s <= "
                         f"{MAX_SINGLE_BLOCK}; got heads={heads}, d={F / 3 / heads:g}, s={s}")
    if qkv.device.type == "cpu":
        fwd, bwd = long_qkv_attention_fwd_ref, long_qkv_attention_bwd_ref
    elif qkv.dtype != torch.bfloat16:
        raise ValueError(f"long_qkv_attention takes bfloat16 on the card, got {qkv.dtype}")
    else:
        fwd, bwd = _long_fwd_kernel, _long_bwd_kernel
    return _LongAttention.apply(qkv, heads, fwd, bwd)[0]


long_qkv_attention.launches = 0
long_qkv_attention.bwd_launches = 0
