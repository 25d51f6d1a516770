"""The model FLOPs of the real images trained on in the traced window
(forward and backward, ``counts/model_flops.py``), over the window, the
cards and the peak of the configuration's precision."""

from portbench.counts.model_flops import TRAIN
from portbench.counts.peaks import peak


def read(ctx):
    if ctx.kind != "train" or not ctx.trace["kernels"] or not ctx.trace["images"]:
        return None
    cfg = ctx.config
    flops = ctx.trace["images"] * TRAIN[cfg["family"]](cfg)
    return 100.0 * flops / (ctx.trace["window_s"] * ctx.chips
                            * peak(cfg["train"]["peak_precision"]))
