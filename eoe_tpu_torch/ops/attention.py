"""Fused QKV self-attention for the CLIP encoders: the CUDA kernel and its
plain PyTorch version.

``fused_qkv_attention`` is the port of eoe_tpu/ops/attention.py's
``fused_qkv_attention`` forward (the Pallas kernel ``_fwd_compute``). It
consumes the un-transposed joint projection ``(n, s, 3*H*d)`` and returns
``(n, s, H*d)``. On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_qkv_attention.cu`` (built at first use, see ``_build``) or
raises; on a CPU tensor it computes the same function with
``fused_qkv_attention_ref``. Gradients are not ported yet: the CUDA path is
for inference.
"""

import ctypes
import functools
from typing import Optional

import torch

from eoe_tpu_torch.ops import _build

LANE = 128      # the JAX kernel's lane group; heads must tile it evenly
MAX_SEQ = 128   # one tile covers the whole sequence
SOURCE = "fused_qkv_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(n, heads, s, d) scaled dot-product attention; logits and softmax in
    fp32, probabilities cast to v's dtype (eoe_tpu/models/clip/model.py:83)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", probs, v)


def _check_fused_shape(heads: int, d: int, s: int):
    """Reject what the fused kernel does not compute (the JAX gate,
    eoe_tpu/ops/attention.py:592): head dims other than 64 and 128, head
    counts that do not tile a 128-lane group, sequences over one tile."""
    per = LANE // d if d in (64, 128) else 0
    if per == 0 or heads % per != 0:
        raise ValueError(
            f"fused_qkv_attention requires d in (64, 128) and "
            f"heads%(LANE//d)==0; got heads={heads}, d={d} "
            f"(use fused_qkv_ok() to gate)")
    if s > MAX_SEQ:
        raise ValueError(f"sequence {s} exceeds the single-tile budget {MAX_SEQ}")


def fused_qkv_ok(n: int, s: int, heads: int, d: int,
                 sample: Optional[torch.Tensor] = None) -> bool:
    """Whether the CUDA kernel applies: ``sample`` (the projection) lies on a
    CUDA device and the shape passes the gate. The dtype is not consulted: on
    the card a dtype the kernel does not take raises in
    ``fused_qkv_attention`` rather than running the plain version."""
    if sample is None or not sample.is_cuda:
        return False
    aligned = (d == 64 and heads % 2 == 0) or d == 128
    return aligned and s <= MAX_SEQ and n >= 1


def fused_qkv_attention_ref(qkv: torch.Tensor, heads: int,
                            causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the numerics of
    ``_fwd_group_math`` (eoe_tpu/ops/attention.py:184): for d=64, q is
    pre-scaled by 2^-3 in the input dtype; for d=128 the fp32 logits are
    scaled. Masked logits get -1e30, the softmax is fp32, P is rounded to the
    input dtype, and P.V accumulates in fp32."""
    n, s, F = qkv.shape
    D = F // 3
    d = D // heads
    _check_fused_shape(heads, d, s)
    q, k, v = qkv.reshape(n, s, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    scale = d ** -0.5
    if d == 64:
        logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        future = torch.ones(s, s, dtype=torch.bool, device=qkv.device).triu(1)
        logits = logits.masked_fill(future, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(p.float(), v.float()).to(qkv.dtype)  # (n, h, s, d)
    return out.transpose(1, 2).reshape(n, s, D)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.eoe_fused_qkv_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.eoe_fused_qkv_attention_fwd.restype = ctypes.c_int
    lib.eoe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_qkv_attention(qkv: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Multi-head self-attention fused over the concatenated projection.

    ``qkv``: (n, s, 3*D), features ordered [q | k | v] with heads contiguous
    inside each. Returns (n, s, D), heads concatenated, un-transposed.
    ``causal`` applies the upper-triangular mask of the CLIP text encoder.
    ``fused_qkv_attention.launches`` counts the kernel's launches."""
    n, s, F = qkv.shape
    D = F // 3
    d = D // heads
    _check_fused_shape(heads, d, s)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_ref(qkv, heads, causal)
    if not qkv.is_cuda:
        raise ValueError(f"fused_qkv_attention runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_qkv_attention takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention needs a contiguous qkv")
    if qkv.data_ptr() % 4:
        raise ValueError("fused_qkv_attention reads qkv in 4-byte words; it is misaligned")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("the fused attention backward is not ported yet")
    out = torch.empty((n, s, D), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):  # the launcher uses the current device
        err = lib.eoe_fused_qkv_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), n, s, heads, d, _DTYPE_CODES[qkv.dtype],
            int(causal), d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fused_qkv_attention launch failed: "
                           + lib.eoe_cuda_error_string(err).decode())
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
