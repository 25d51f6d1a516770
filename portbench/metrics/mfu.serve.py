"""The model FLOPs of the images scored in the traced window (the forward
pass; padded slots are not counted), over the window and the peak of the
configuration's serving precision."""

from portbench.counts.model_flops import FORWARD
from portbench.counts.peaks import peak


def read(ctx):
    if ctx.kind != "serve" or not ctx.trace["kernels"] or not ctx.trace["images"]:
        return None
    cfg = ctx.config
    flops = ctx.trace["images"] * FORWARD[cfg["family"]](cfg)
    return 100.0 * flops / (ctx.trace["window_s"] * ctx.chips
                            * peak(cfg["serve"]["peak_precision"]))
