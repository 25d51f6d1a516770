"""Device kernel name -> class, for the breakdown: a frozen copy of
``profile_train.py:55-77`` (``kernel_class``), with NCCL's kernels beside
it."""


def kernel_class(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "collectives (NCCL)"
    if "augment_" in low:
        return "augmentation (port kernel)"
    if any(k in low for k in ("flash_tc", "flash_tile", "flash_fwd_kernel")):
        return "flash attention forward (port kernel)"
    if "fused_qkv_bwd" in low:
        return "attention backward (port kernel)"
    if "fused_qkv_fwd" in low:
        return "attention forward (port kernel)"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn",
                              "nchwtonhwc", "nhwctonchw")):
        return "convolutions (cuDNN)"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "sm90_")):
        return "matrix products (cuBLAS)"
    if "layer_norm" in low or "layernorm" in low:
        return "layer norm"
    if any(k in low for k in ("elementwise", "vectorized", "unrolled", "reduce", "index",
                              "gather", "scatter", "copy", "cat", "fill")):
        return "elementwise, reductions, copies"
    return "other"
