"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). The rates and the HBM
bandwidth are those of ``chip_smoke.py:196-197``, with TF32 beside them."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bfloat16": 989e12,   # tensor cores, bf16 and fp16
    "tf32": 495e12,       # tensor cores, TF32
    "float32": 67e12,     # CUDA cores, float32 products with TF32 off
}


def peak(precision: str) -> float:
    """The peak of a configuration's ``peak_precision``."""
    return PEAK_OPS_PER_S[precision]


def bound_s(nbytes: float, ops: float, precision: str) -> float:
    """The least time of a call: the larger of its bytes over the HBM
    bandwidth and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision])
