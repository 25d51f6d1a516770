"""The card's idle share of the traced training window: the window less the
union of its kernels' intervals, over the window (rank 0's card)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace["kernels"]:
        return None
    return 100.0 * (ctx.trace["window_s"] - ctx.trace["busy_s"]) / ctx.trace["window_s"]
