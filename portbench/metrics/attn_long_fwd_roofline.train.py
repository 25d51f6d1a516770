"""The long attention's forward kernel (``long_fwd_kernel``: the flash
kernel's tensor-core stream, which the image tower runs at 257 tokens, under
a name of its own) in the traced training
window against its roofline: the sum of each call's bound
(``counts/attention`` at the image tower's shape: the rank's whole batch of
both halves, its tokens, heads and head size, the compute dtype) over the
sum of the calls' device times. No such kernel in the trace: nothing to
read."""

from portbench.counts.attention import attention_bytes, attention_ops
from portbench.counts.peaks import bound_s

CALLS, PARTS, BACKWARD = "long_fwd_kernel", ("long_fwd_kernel",), False


def read(ctx):
    if ctx.kind != "train":
        return None
    calls = ctx.kernels(CALLS)
    if not calls:
        return None
    cfg = ctx.config
    group = cfg["train"]
    rows = 2 * group["batch_size"] // ctx.chips
    s = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    heads, d = cfg["vision_width"] // 64, 64
    bound = bound_s(attention_bytes(rows, s, heads, d, group["compute_dtype"], BACKWARD),
                    attention_ops(rows, s, heads, d, False, BACKWARD), group["peak_precision"])
    return 100.0 * len(calls) * bound / ctx.seconds(ctx.kernels(*PARTS))
