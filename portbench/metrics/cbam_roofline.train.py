"""CBAM's kernels of the traced training window against their roofline: the
window's steps times the compulsory bytes of the gates and block tails of a
step (``counts/cbam``: the rank's whole batch of both halves, the compute
dtype), over the HBM bandwidth, over the summed device time of the kernels
whose names hold ``cbam_``. Any design moves those bytes, so the reading
stays under 100%. No such kernel in the trace: nothing to read."""

from portbench.counts.cbam import chain_bytes
from portbench.counts.peaks import HBM_BYTES_PER_S


def read(ctx):
    if ctx.kind != "train" or ctx.config["family"] != "wrn_cbam":
        return None
    calls = ctx.kernels("cbam_")
    if not calls or not ctx.trace["steps"]:
        return None
    tr = ctx.config["train"]
    rows = 2 * tr["batch_size"] // ctx.chips
    nbytes = ctx.trace["steps"] * chain_bytes(ctx.config, rows, tr["compute_dtype"])
    return 100.0 * nbytes / HBM_BYTES_PER_S / ctx.seconds(calls)
