"""The fused-QKV attention forward kernels of the traced serving window
against their roofline: the sum of each call's bound (``counts/attention``
at the image tower's shape: a padded batch, its
tokens, heads and head size, the compute dtype) over the sum of their
device times. No such kernel in the trace: nothing to read."""

from portbench.counts.attention import attention_bytes, attention_ops
from portbench.counts.peaks import bound_s

PART, BACKWARD, KIND = "fused_qkv_fwd", False, "serve"


def read(ctx):
    if ctx.kind != KIND:
        return None
    calls = ctx.kernels(PART)
    if not calls:
        return None
    cfg = ctx.config
    group = cfg[KIND]
    rows = (2 if KIND == "train" else 1) * group["batch_size"] // ctx.chips
    s = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    heads, d = cfg["vision_width"] // 64, 64
    bound = bound_s(attention_bytes(rows, s, heads, d, group["compute_dtype"], BACKWARD),
                    attention_ops(rows, s, heads, d, False, BACKWARD), group["peak_precision"])
    return 100.0 * len(calls) * bound / ctx.seconds(calls)
