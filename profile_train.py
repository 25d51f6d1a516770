#!/usr/bin/env python3
"""Where the time of the port's training step, or of a serving request, goes,
on one NVIDIA GPU.

    python3 profile_train.py [--steps 3] [--route fused|group|flash] [--serving]
                             [--dtype bfloat16|float32] [--model clip|cnn32|wrn]
                             [--vmap K] [--ways graph,eager] [--trace train_trace.json]

Builds chip_smoke.py's training configuration (full-width ViT-B/32 in bf16,
HSC, the acceptance augmentation stack, 128 normal + 128 OE images per
step, random weights from seed 0), takes two warm-up steps, then traces
``--steps`` steps with ``torch.profiler`` (CPU and CUDA activities). Prints
the step time on the host clock (untraced, then traced), the device time by
kernel class (the attention kernels, matrix products, everything else) and
the device's busy share of the traced window (one run: its device time over
its own host clock), then the 25 kernels with the most device time. ``--route`` picks the attention: the fused-QKV kernels on
their monolithic grid (the default), on the lane-group grid
(``GROUP_GRID``), or ``CLIP(attention_fn=flash_attention)``. ``--dtype
float32`` trains the same step in fp32 (TF32 off, as the parity runs of
chip_smoke.py), which takes the fp32 kernels. With ``--serving`` each step
is instead one fp32 request of 256 raw 32x32 images through
``AnomalyScorer`` with the CLIP objective (chip_smoke.py's serving
phase, the prompt centre computed once before). ``--model cnn32`` profiles
chip_smoke.py's conv_training step instead (CNN32, fp32, HSC, the
benchmark's CIFAR-10 stack on 32x32 images), ``--model wrn`` its
wrn_training step (WideResNet+CBAM, bf16, HSC, the ImageNet-30 stack on
256x256 images, the fused stem); ``--dtype`` then overrides the step's own
dtype only when given. ``--vmap K`` profiles the training step of K
members stacked as the vmapped seed engine trains them
(``training.vmapped_seeds``: one step updates every member, each on the
same batch with its own augmentation draws), K x (128 + 128) images a
step. The steps run with the modules labelled (``record_function``
ranges): the pipeline calls (``Trainer._preprocess``), the per-step weight
casts (CLIP's ``_dense``, the conv layers' ``_cast``), the norms
(``LayerNormF32``, ``BatchNorm``); with the optimizer's own range and the
autograd engine's, each kernel's device time is split by the module that
launched it, then by class. ``--ways`` profiles the training step in each
way it names, one after another in one process: ``graph`` (the default for
a training step, the step the trainers take on the card: the resident
epoch's, ``training.graphs``: its plan row read at a device counter and
replayed from a captured one-step CUDA graph; one member only), ``eager``
(the per-step loop's step; the only way of ``--serving``). A graph's
kernels link to the replay, not to a module, so its split by module is
empty. Needs one card; imports nothing of JAX or
eoe_tpu.
"""

import argparse
import functools
import os
import sys
import time


def kernel_class(name: str) -> str:
    low = name.lower()
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


LABEL = "module: "


def label_modules():
    """Wrap the modules the split reports in ``record_function`` ranges of
    their names."""
    import torch
    from eoe_tpu_torch.models import layers
    from eoe_tpu_torch.models.clip import model as clip_model
    from eoe_tpu_torch.training.trainer import Trainer

    def ranged(label, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with torch.profiler.record_function(LABEL + label):
                return fn(*args, **kw)
        return inner

    Trainer._preprocess = ranged("augmentation", Trainer._preprocess)
    clip_model._dense = ranged("weight casts", clip_model._dense)
    layers._Weighted._cast = ranged("weight casts", layers._Weighted._cast)
    clip_model.LayerNormF32.forward = ranged("norms", clip_model.LayerNormF32.forward)
    layers.BatchNorm.forward = ranged("norms", layers.BatchNorm.forward)


def module_of(event) -> str:
    """The labelled module around a CPU event, the optimizer, the backward
    pass, or the rest of the forward."""
    while event is not None:
        name = event.name
        if name.startswith(LABEL):
            return name[len(LABEL):]
        if name.startswith("Optimizer.step"):
            return "optimizer"
        if name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        event = event.cpu_parent
    return "rest of the forward"


def is_annotation(event) -> bool:
    """A ``record_function`` range's span on the device timeline, not a
    kernel."""
    return bool(getattr(event, "is_user_annotation", False)) or event.name.startswith(
        (LABEL, "Optimizer."))


def by_module(prof, steps: int, device_ms: dict) -> dict:
    """{module: {kernel class: device ms per step}} over the kernels the
    profiler linked to a CPU event. A kernel launched through ctypes has no
    op to link to: the port's augmentation kernels' unlinked time goes to
    the augmentation module (nothing else launches them), the rest of each
    class's unlinked time to "not linked"."""
    import torch
    out, linked = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            if is_annotation(k):
                continue
            name, ms = kernel_class(k.name), k.duration / 1e3 / steps
            cls = out.setdefault(module_of(e), {})
            cls[name] = cls.get(name, 0.0) + ms
            linked[name] = linked.get(name, 0.0) + ms
    for name, ms in device_ms.items():
        rest = ms - linked.get(name, 0.0)
        if rest > 1e-6:
            module = "augmentation" if name == "augmentation (port kernel)" else "not linked"
            cls = out.setdefault(module, {})
            cls[name] = cls.get(name, 0.0) + rest
    return out


def training_step(cs, kw, dtype, k, graph=False):
    """chip_smoke.py's HSC training step on the acceptance stack, in
    ``dtype`` (bf16 as trained there by default)."""
    import numpy as np
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    ds, _ = cs._combined(np.random.default_rng(cs.SEED), cs.ACCEPTANCE_SPECS)
    trainer = cs._trainer(CLIP(VIT_B32, dtype=dtype, **kw), cs.ACCEPTANCE_SPECS, None, dtype)
    return _steps(trainer, ds, cs.BATCH, k, graph), 2 * cs.BATCH * k


def conv_step(cs, model_name, dtype, k, graph=False):
    """chip_smoke.py's conv_training (CNN32) or wrn_training (WideResNet)
    step, in ``dtype`` if given, else the path's own (fp32, bf16)."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models import CNN32, WideResNet
    if model_name == "cnn32":
        model, hw, n, specs, test_specs = CNN32(), 32, cs.CONV_N, cs.CIFAR_SPECS, ["normalize"]
        dtype = dtype or torch.float32
    else:
        model, hw, n, specs, test_specs = (WideResNet(), 256, cs.WRN_N, cs.WRN_SPECS,
                                           cs.WRN_TEST_SPECS)
        dtype = dtype or torch.bfloat16
    ds, _ = cs._pinned(np.random.default_rng(cs.SEED), hw, n, 8, specs, test_specs)
    trainer = cs._conv_trainer("hsc", model, specs, test_specs, None, dtype, 1)
    return _steps(trainer, ds, cs.BATCH, k, graph), 2 * cs.BATCH * k


def _steps(trainer, ds, batch, k, graph=False):
    """A step function over the pinned set's batches, in turn: one member
    from seed 0 (``k`` = 1), or ``k`` stacked members from seeds 0..k-1.
    With ``graph``, one member's step as the resident epoch runs it: the
    batches' positions as the plan, a one-step graph captured at the second
    call and replayed from then on."""
    import numpy as np
    import torch
    from eoe_tpu_torch.training import graphs
    from eoe_tpu_torch.training import vmapped_seeds as V
    dev = trainer.device
    xn = torch.from_numpy(ds.train_set.gather_all()).to(dev)
    xo = torch.from_numpy(ds.oe.train_set.gather_all()).to(dev)
    ln = torch.zeros(len(xn), dtype=torch.int64, device=dev)
    lo = torch.ones(len(xo), dtype=torch.int64, device=dev)
    w = torch.ones(batch, device=dev)
    gens = [torch.Generator(device=dev).manual_seed(m) for m in range(k)]
    n_batches = len(xn) // batch
    if graph:
        if k != 1:
            sys.exit("profile_train.py: --ways graph profiles one member (--vmap 1)")
        state = trainer.init_state(0, ds, 1)
        idx = np.arange(n_batches * batch).reshape(n_batches, batch)
        plans = graphs.DevicePlans([graphs.pack_plan(idx, idx, np.ones_like(idx))], 1, dev)
        os.environ["EOE_TPU_CHUNK"] = "1"
        try:
            runner, _ = trainer.make_train_epoch_resident(state, ds, (xn, ln, xo, lo), plans,
                                                          n_batches, gens[0], None, None)
        finally:
            os.environ.pop("EOE_TPU_CHUNK")
        return lambda i: runner.run(1)
    if k == 1:
        state = trainer.init_state(0, ds, 1)
    else:
        stack = trainer.init_states_stacked(list(range(k)), 1)
        members = lambda t: t.expand(k, *t.shape)   # noqa: E731

    def step(i):
        sl = slice((i % n_batches) * batch, (i % n_batches + 1) * batch)
        if k == 1:
            return trainer.train_step(state, ds, xn[sl], ln[sl], xo[sl], lo[sl], w, gens[0])
        return V.stacked_step(trainer, ds, stack, members(xn[sl]), members(ln[sl]),
                              members(xo[sl]), members(lo[sl]), members(w), gens, None,
                              trainer._rt_stats(ds))
    return step


def serving_step(cs, kw):
    """chip_smoke.py's fp32 serving request of 256 images (CLIP objective)."""
    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center
    specs = [{"op": "clip_pil_preprocessing", "resolution": VIT_B32.image_resolution},
             {"op": "clip_tensor_preprocessing"}]
    model = CLIP(VIT_B32, generator=torch.Generator().manual_seed(cs.SEED), **kw)
    snapshot = {"params": {k: v.clone() for k, v in model.state_dict().items()},
                "setup": {"test_specs": specs}}
    model.to("cuda")
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=cs.BATCH, center=center)
    images = np.random.default_rng(cs.SEED).integers(0, 256, (cs.REQUESTS[0], 32, 32, 3),
                                                     dtype=np.uint8)
    return (lambda i: scorer.score(images)), cs.REQUESTS[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--route", choices=("fused", "group", "flash"), default="fused",
                        help="the attention route the model takes")
    parser.add_argument("--serving", action="store_true",
                        help="profile an fp32 scoring request of 256 images, not a training step")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                        help="the training step's compute dtype (CLIP: bfloat16 by default)")
    parser.add_argument("--model", choices=("clip", "cnn32", "wrn"), default="clip",
                        help="the model whose training step is profiled")
    parser.add_argument("--vmap", type=int, default=1, metavar="K",
                        help="profile the step of K stacked members (the vmapped engine)")
    parser.add_argument("--ways", default=None,
                        help="comma-separated: graph (the resident step replayed from a "
                             "captured CUDA graph; the default for a training step) and/or "
                             "eager (the per-step loop's step; the default with --serving)")
    parser.add_argument("--trace", default="", help="write a chrome trace here")
    args = parser.parse_args()
    args.ways = args.ways or ("eager" if args.serving else "graph")
    ways = args.ways.split(",")
    if set(ways) - {"eager", "graph"} or (args.serving and "graph" in ways):
        parser.error("--ways takes eager and graph, and graph only for a training step")

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_train.py: torch.cuda.is_available() is false: it needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from eoe_tpu_torch.ops import attention

    card = cs.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype) if args.dtype else None
    attention.GROUP_GRID = args.route == "group"
    kw = {"attention_fn": attention.flash_attention} if args.route == "flash" else {}
    label_modules()   # before any capture: a graph holds the ranges it captured
    for way in ways:
        graph = way == "graph"
        if args.model != "clip":
            what = f"training {args.model} {args.dtype or 'in its own dtype'}"
            step, images = conv_step(cs, args.model, dtype, args.vmap, graph)
        elif args.serving:
            what = "serving fp32"
            step, images = serving_step(cs, kw)
        else:
            what = f"training {args.dtype or 'bfloat16'}"
            step, images = training_step(cs, kw, dtype or torch.bfloat16, args.vmap, graph)
        if args.vmap > 1:
            what += f", {args.vmap} members stacked"
        print(f"profile: model {args.model}, route {args.route}, {what}, {way}")
        profile_step(args, way, step, images, card)
        del step
        torch.cuda.empty_cache()


def profile_step(args, way, step, images, card):
    """Warm-up, the untraced host clock, then ``args.steps`` traced steps:
    the device time by class and by module, and the top kernels."""
    import torch
    tag = f"profile[{way}]"
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        step(i)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / args.steps
    print(f"{tag}: {plain * 1e3:.2f} ms per step untraced, host clock = "
          f"{images / plain:.1f} img/s [{card}]")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = wall / args.steps * 1e3
    imgs = images / (wall / args.steps)
    print(f"{tag}: {args.steps} traced steps of {images} images, "
          f"{step_ms:.2f} ms per step on the host clock (tracing included) = "
          f"{imgs:.1f} img/s [{card}]")

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not is_annotation(e)]
    device_us = {}
    for e in kernels:
        cls = kernel_class(e.name)
        device_us[cls] = device_us.get(cls, 0.0) + e.device_time_total
    total = sum(device_us.values())
    if total <= 0:
        sys.exit(f"profile_train.py: the profiler recorded no device time ({way})")
    print(f"{tag}: device busy {total / 1e3 / args.steps:.2f} ms per step, "
          f"{100 * total / 1e3 / (wall * 1e3):.1f}% of the traced window (the busy share); "
          f"over the untraced steps' clock, a ratio of two runs: "
          f"{100 * total / 1e3 / (plain * 1e3 * args.steps):.1f}%")
    for cls, us in sorted(device_us.items(), key=lambda kv: -kv[1]):
        print(f"{tag}:   {cls}: {us / 1e3 / args.steps:.3f} ms per step "
              f"({100 * us / total:.1f}% of device time)")
    modules = by_module(prof, args.steps,
                        {cls: us / 1e3 / args.steps for cls, us in device_us.items()})
    print(f"{tag}: by module (the op that launched each kernel), device ms per step:")
    for module, classes in sorted(modules.items(), key=lambda kv: -sum(kv[1].values())):
        parts = ", ".join(f"{cls} {ms:.3f}" for cls, ms in
                          sorted(classes.items(), key=lambda kv: -kv[1]))
        print(f"{tag}:   {module}: {sum(classes.values()):.3f} ({parts})")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25,
                                    max_name_column_width=70))
    if args.trace:
        trace = args.trace if len(args.ways.split(",")) == 1 else \
            args.trace.replace(".json", f"_{way}.json")
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
        print(f"{tag}: chrome trace written to {trace}")


if __name__ == "__main__":
    main()
