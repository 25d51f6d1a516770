"""Milliseconds a training step spends in NCCL's kernels on rank 0's card
(the gradient sum of ``parallel/mesh.py`` ``all_reduce_grads`` and the
epoch's gathers), over the traced window's steps. No NCCL kernel in the
trace: nothing to read."""


def read(ctx):
    if ctx.kind != "train" or not ctx.trace["steps"]:
        return None
    calls = ctx.kernels("nccl", "Nccl", "NCCL")
    if not calls:
        return None
    return 1e3 * ctx.seconds(calls) / ctx.trace["steps"]
