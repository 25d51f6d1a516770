"""The augmentation pair (the stats and the apply kernel of each half's
random crop step) of the traced training window against its roofline: each
apply call's bound (``counts/augment``: the half's images at the stack's
shapes, bytes over the HBM bandwidth) summed, over the summed device times
of both kernels. No apply kernel in the trace: nothing to read."""

from portbench.counts.augment import pair_bytes, stack_shape
from portbench.counts.peaks import HBM_BYTES_PER_S


def read(ctx):
    if ctx.kind != "train":
        return None
    apply = ctx.kernels("augment_apply")
    if not apply:
        return None
    tr = ctx.config["train"]
    crop, contrast, noise = stack_shape(tr["specs"])
    n = tr["batch_size"] // ctx.chips
    nbytes = pair_bytes(n, ctx.traffic["raw_size"], crop, ctx.traffic["channels"], 1, 4,
                        contrast, noise)
    spent = ctx.seconds(apply) + ctx.seconds(ctx.kernels("augment_stats"))
    return 100.0 * len(apply) * nbytes / HBM_BYTES_PER_S / spent
