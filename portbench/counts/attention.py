"""Operations and bytes of one fused-QKV attention call, as
``chip_smoke.py:434-445`` (``attention_bound_ms``) counts them, whatever
kernel computes it. Forward: read qkv (3 H d a row) once, write the output
(H d) once; two products of 2 s^2 d operations an image and head.
Backward: read qkv and dout, write d(qkv): 7 H d a row; five products
(QK^T recomputed, dV, dP, dQ, dK). Causal rows need only their prefix of
keys."""

ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def attention_bytes(n: int, s: int, heads: int, d: int, dtype: str, backward: bool) -> int:
    return n * s * (7 if backward else 4) * heads * d * ELEM_BYTES[dtype]


def attention_ops(n: int, s: int, heads: int, d: int, causal: bool, backward: bool) -> int:
    pairs = s * (s + 1) // 2 if causal else s * s
    return (10 if backward else 4) * n * heads * pairs * d
