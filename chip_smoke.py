#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: the card's name and power limit, as nvidia-smi reports them;
  2. build: every kernel of the port, compiled from this checkout's sources,
     one nvcc per source, all started together: the fused-QKV attention
     forward and backward on both grids (one source), the flash attention
     forward (another) and the augmentation kernels (a third);
  3. kernels: each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, with its time beside the plain version's and
     one PyTorch library call's (a yardstick the port never calls): SDPA's
     forward, and SDPA's backward through a retained forward. The lane-group
     kernels are also held against the monolithic ones; then augment: the
     augmentation kernels (stats, apply) against their plain versions at
     the crop steps of the acceptance, ImageNet-30 and CIFAR-10 stacks, one
     half-batch of 128 raw images in uint8 and in fp32, each kernel's
     registers and spills first (``phase_augment``); then cbam: CBAM's
     gate and block-tail kernels (``ops.cbam``) against their plain
     versions at WideResNet's stage-1 shape (256, 56, 56, 64) in fp32 and
     bf16, each timed beside its plain version and its bound, and a
     block's CBAM and tail, forward and backward, against the plain chain
     (``phase_cbam``);
  4. serving (the first slice): CLIP ViT-B/32 anomaly scoring at full width
     with random weights from seed 0: the CIFAR-10 one-vs-rest prompt
     centre, then three requests (256, 100 and 37 raw 32x32 uint8 images)
     through ``AnomalyScorer``, held against the same model run through the
     kernels' plain versions; one request again with the HSC objective in
     bf16;
  5. training (the second slice): ``Trainer`` on a full-width ViT-B/32 in
     bf16 with the HSC objective and the acceptance augmentation stack, on
     seeded uint8 256x256 sets of 512 normal, 512 OE and 256 test images: two
     epochs of 4 steps of 128 + 128 images, ``eval_cls`` and a snapshot; the
     launch counts must be 12 forward and 12 backward per step plus 12
     forward per eval batch, and 2 stats + 2 apply augmentation launches per
     step and 2 + 2 for the preview. Then 3 fp32 steps (TF32 off, deterministic
     pipeline; 36 forward and 36 backward launches, every backward in the
     resident design, a path of its own in the counts) twice, through the kernels and through their plain versions
     (``fused_qkv_attention_ref``), held against each other; one bf16 step
     the same way (the bf16 hold); and the snapshot served through
     ``AnomalyScorer``, held against ``eval_cls``;
  6. flash path: ``CLIP(VIT_B32, attention_fn=flash_attention)`` from seed 0
     serves phase 4's prompt centre and requests (12 flash launches for the
     prompts and 12 per batch), held in fp32 against the same weights with
     ``attention_fn=default_attention``; then trains one bf16 epoch of 4
     steps and ``eval_cls`` (12 launches per step and per eval batch, no
     backward kernel), and 3 fp32 steps against 3 with
     ``default_attention`` at phase 5's limits. Every fp32 launch must take
     the flash kernel's fp32 register tiles, every bf16 launch its tensor
     cores;
  7. group-grid path: with ``attention.GROUP_GRID`` set (the JAX package's
     ``EOE_TPU_ATTN_GROUP_GRID=1``), one bf16 epoch of 4 steps and
     ``eval_cls`` (12 group forward launches per step and per eval batch, 12
     group backward per step, no monolithic launch), 3 fp32 steps (36 group
     launches each way, the backward's resident, counted as a path) against
     3 on the monolithic grid,
     and the snapshot served through ``AnomalyScorer``;
  8. conv_training: CNN32 in fp32 (TF32 off) with HSC on the JAX package's
     benchmark CIFAR-10 stack (bench.py:91-103), 2048 + 2048 seeded raw
     32x32 images for 2 epochs of 128 + 128, img/s per epoch, the snapshot
     served through ``AnomalyScorer`` against ``eval_cls``; then one class
     and one epoch by name (cifar10 with cifar100 as OE, the synthetic data
     of ``EOE_TPU_FAKE_DATA=1``) of hsc, bce (``clf=True``), dsvdd and ae
     (AE32): finite losses and a results.json;
  9. wrn_training: WideResNet+CBAM in bf16 with HSC on the benchmark's
     ImageNet-30 stack (bench.py:71-90), 512 + 512 raw 256x256 images for 8
     steps, served back; the fused stem in fp32 at (8, 224, 224, 3) and at
     the full batch of 256: its forward (the plain stem's own code) against
     torch's ``F.batch_norm`` composition to 1e-5 of its max, its backward
     against the plain stem under autograd to 1e-4; one fp32 step with the
     fused stem against one with ``EOE_TPU_FUSED_STEM=0`` at phase 5's
     limits.
     No attention kernel lies on phases 8 and 9; the augmentation kernels
     launch once per train-pipeline call (apply; the stats where the guard
     is on: WRN), 2 a step and 2 for the preview, and 0 on the fixed
     pipelines of the by-name runs and the fp32 steps.
     Every resident, one-process training run of these and the later
     phases goes through the resident epoch (``training.graphs``: the step
     captured as a CUDA graph and replayed) and keeps its holds and counts;
  resident: the resident epoch against the eager loop (``_Eager``), cuDNN
     deterministic: (a) CNN32 fp32 on phase 8's pinned stack, 2 epochs,
     with SGD in turns (eager, one-step graphs, whole-epoch graphs): losses,
     parameters and AUROC 1e-5; then with Adam, held by drift
     (``ADAM_DRIFT_TOL``); (b) ViT-B/32 bf16 on phase 5's data, 4 steps:
     losses 2^-8, 12 + 12 fused launches a step both ways; (c) 4 vmapped
     CNN32 seeds (SGD): every member's losses, AUROC and parameters 1e-5;
     (d) one generation of ``evolve_oe_cifar --ev-vmap`` (SGD): the same
     population, fitnesses 1e-4; each with its seconds, img/s, ms a step
     and the card's busy share both ways; (e) ``train_cifar`` with the
     logger's background writer and with ``EOE_TPU_SYNC_IO=1``: the same
     files and snapshot tensors, the seconds of each.
Later phases: filters, cli, folder, evolve and custom (the runners and data
layers of later slices, see their docstrings), then
 15. vmapped: the vmapped engines. (a) ``train_cifar`` by ``main`` with 4
     seeds of class 0 for 2 epochs (the runner's defaults: 10 seeds, 200
     epochs) on the synthetic data, its default (which must log "trained 4
     seeds of cls 0 vmapped") against ``--no-vmap-seeds`` (each seed's AUROC
     to 1e-4), then 4 CNN32 seeds on phase 8's pinned stack both ways, with
     Adam (each member's parameters against its seed's, over their change:
     2^-4) and with SGD; (b)
     two WideResNet+CBAM bf16 members with the fused stem for 3 steps, each
     against its sequential seed (losses 2^-8, gradients 2^-4 of their max),
     peak memory per member; (c) ``train_clip_cifar --vmap-seeds`` with two
     seeds at full ViT-B/32 width: 12 fused forward and 12 backward launches
     per step on the 2 x 256 folded images, losses within 2^-8 of
     ``--no-vmap-seeds``; (d) ``evolve_oe_cifar --ev-vmap`` against the
     sequential evaluator with sequential seeds at phase evolve's settings
     (equal populations, each candidate's AUROC to 1e-4 or a tied test
     pair), seconds per individual; (e) one folded call of each kernel at
     K=2 against the unfolded kernel on each member; (f) ``train_imagenet``
     with 10 WideResNet seeds both ways and ``evolve_oe_imagenet --ev-vmap``
     with 16 candidates, in fp32 at 224 px, each program as many members as
     the card holds by their measured peaks. (a) and (d) are timed through
     ``utils.profiling.step_timer`` and profiled (the card's busy time);
     each of (a)-(d) and (f) is a counted path;
 16. ga_distances: the GA's mutation and mating distances to 10,000 raw
     256x256 candidates, chunked against unchunked: peak memory and values;
 17. clip_rn50: CLIP RN50 at its published width from an OpenAI-style fp16
     checkpoint made from seed 0, through ``train_clip_cifar``'s ``main``
     (3 steps of 128 + 128 in bf16 on the synthetic class 0): 12 fused
     forward launches (the prompt centre), none in the ResNet tower; the
     snapshot served against the run's scores (1e-4), the fp32 centre
     through the kernel against the plain attention (1e-4), an fp32
     request of 256 images, the bf16 step's ms, img/s, busy share and
     peak memory; whether the run wrote tensorboard events;
 18. import: reference-style CNN32, WideResNet+CBAM and bare
     wide_resnet50_2 trunk snapshots at full width through
     ``import_snapshot``, each evaluated on the card by a runner's
     ``--load`` (``train_cifar``, ``train_imagenet``), its features equal
     to the source model's (1e-4), its scores not constant, the parameters
     equal to the sources; no kernel launches;
 19. pool: ``ops.pool.max_pool_3x3_s2_p1`` against ``F.max_pool2d`` on the
     WRN stem's (256, 64, 112, 112) in fp32 and bf16, forward and gradient,
     with both times;
 20. dp: the data axis (``parallel.mesh``), one process and then two ranks
     sharing the card (EOE_TPU_DISTRIBUTED=1, gloo: NCCL refuses two ranks
     on a device), all on the per-step loop (``_Eager``),
     each process running (a)-(d) of ``dp_child``: (a)
     ``train_clip_cifar`` ViT-B/32 bf16 HSC, 4 steps of 128 + 128 (64 + 64
     a rank): each rank's losses within 2^-8 of the process's, scores and
     AUROC 1e-4 or a tie, 12 + 12 fused launches a step as one process on
     the rank's 128 images (64 an eval batch), the step's ms a rank beside
     the process's and a gloo all-reduce of the trained gradients' bytes;
     (b) ``train_cifar`` CNN32 fp32: losses and parameters 1e-5; (c) 4
     seeds ``--vmap-seeds``, 2 a rank: AUROCs 1e-4 or a tie; (d)
     ``evolve_oe_cifar --ev-vmap``, generation 0's two candidates one a
     rank: fitnesses 1e-4, populations equal. (b)-(d) update with SGD;
 21. tp: the model axis (``parallel.mesh``'s Megatron split), one process
     and then two ranks sharing the card as a 1 x 2 mesh (gloo), each
     through ``tp_child``: ``ClipTrainer.run`` of ViT-B/32 bf16 from seed
     0's weights, 3 steps of 128 + 128 on the acceptance stack and one eval
     batch of 128, on the per-step loop. Each rank runs the fused pair on
     its 6 image heads and the text tower's 4 causal heads (12 + 36 + 12
     forward and 36 backward launches, one process's, traced as paths
     ``tp_rank0`` and ``tp_rank1``); losses within 2^-8 of the process's,
     the gathered snapshot's change of each trained tensor within 2^-4 of
     its max, scores and AUROC 1e-4 or a tie; step ms per rank. On two or
     more cards the ranks run again over NCCL, a card each;
 22. dp_graph: the resident epoch under a mesh (``phase_dp_graph``). One
     card: (a) a CNN32 fp32 step of the data-parallel code on a one-rank
     NCCL group, captured with its collectives and replayed, bit for bit
     the same steps uncaptured; (b) two gloo ranks sharing the card on a
     grid of 3 CNN32 seeds (2 + 1 members, each rank's programs replayed
     from graphs) against one process. Two or more cards: (c) two NCCL
     ranks, ViT-B/32 bf16 and CNN32 fp32 at 128 + 128 a rank on the graph
     path against the per-step loop and one process, the NCCL, fused and
     augmentation kernels of each rank's trace equal to the counts, a
     rank's step ms both ways; (d) the tiny CLIP on 2 x 1 and, on four
     cards, 2 x 2 meshes. It prints which parts ran, with the card count.
     ``python3 chip_smoke.py --phase dp_graph`` runs the card, the build and
     this phase alone (also resident, dp, tp or cbam), without the result
     lines.
Each path's launch counts (every kernel's) are set to 0 just before it and
read just after. The augmentation counts are held on the training paths of
phases 5-9 and reported on the others. The counters count where a wrapper
launches, and a captured graph's replays launch from no wrapper, so one
counted run of every single-process path (of vmapped (f), its stacked
``train_imagenet``) runs under ``torch.profiler`` (the card's activity):
the launches of the port's kernels that its trace shows, by their
symbols, must equal the counters' over that run (``hold_traced``); the
kernels line gives both under ``traced_by_path``. Those runs' times
carry the profiler's cost; dp's ranks (the per-step loop, child processes)
are not traced; tp's ranks trace themselves and report their traces.

The line before the last is ``{"kernels": [...]}`` (each kernel's bf16 row at
the training shape, its fp32 row under ``"fp32"``, the fused pair's rows at
a tp rank's heads under ``"rank_heads"``, and the variant each path's
launches took); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or eoe_tpu."""

import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12                                    # H100 SXM, data sheet
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}  # CUDA-core fp32; bf16 dense
SEED = 0
REQUESTS = (256, 100, 37)
# the dtype of each counted path's launches: serving scores in fp32, training
# in bf16, and the fp32 training steps of the parity holds
PATH_DTYPES = {"serving": "fp32", "training": "bf16", "training_fp32": "fp32",
               "flash_serving": "fp32", "flash_training": "bf16", "group_training": "bf16",
               "group_training_fp32": "fp32", "conv_training": "fp32", "wrn_training": "bf16",
               "cli_clip": "bf16", "cli_conv": "fp32", "folder_clip": "bf16",
               "folder_conv": "fp32", "evolve": "fp32", "custom": "fp32", "vm_conv": "fp32",
               "vm_wrn": "bf16", "vm_clip": "bf16", "vm_evolve": "fp32",
               "vm_wrn_runners": "fp32", "clip_rn50": "bf16", "import": "fp32",
               "dp_clip_rank0": "bf16", "dp_clip_rank1": "bf16", "dp_conv": "fp32",
               "dp_vmap": "fp32", "dp_evolve": "fp32", "resident_cnn32": "fp32",
               "resident_clip": "bf16", "resident_vmapped": "fp32", "resident_evolve": "fp32",
               "resident_io": "fp32", "tp_one": "bf16", "tp_rank0": "bf16", "tp_rank1": "bf16",
               "tp_one_fp32": "fp32", "tp_rank0_fp32": "fp32", "tp_rank1_fp32": "fp32",
               "dp_graph_capture": "fp32", "dp_graph_grid_rank0": "fp32",
               "dp_graph_grid_rank1": "fp32", "dp_graph_cnn_nccl-rank0": "fp32",
               "dp_graph_cnn_nccl-rank1": "fp32", "dp_graph_vit_nccl-rank0": "bf16",
               "dp_graph_vit_nccl-rank1": "bf16", "vitl14_training": "bf16"}
BATCH = 128
SLEEP_CYCLES = 50_000_000     # ~30 ms of the card's clock: time to queue a timed run


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def _counts() -> dict:
    """Every kernel's launch count, the fp32 fused backward's by design (both
    grids; bf16 takes the tensor cores), the flash kernel's by variant
    (tensor cores, fp32 register tiles; the rest took the CUDA cores) and the
    augmentation kernels' (apply, stats). Ends a trace that ``_zero_counts``
    started and holds it against these counts."""
    from eoe_tpu_torch.ops import augment, cbam
    from eoe_tpu_torch.ops.attention import (default_attention, fused_qkv_attention as fq,
                                             flash_attention as fl, long_qkv_attention as lq)
    counts = {"fwd": fq.launches, "bwd": fq.bwd_launches, "group_fwd": fq.group_launches,
              "group_bwd": fq.group_bwd_launches, "bwd_resident": fq.resident_bwd_launches,
              "bwd_recompute": fq.recompute_bwd_launches, "flash": fl.launches,
              "flash_tc": fl.tc_launches, "flash_tile": fl.tile_launches,
              "augment": augment.launches, "augment_stats": augment.stats_launches,
              "cbam": cbam.launches, "cbam_bwd": cbam.bwd_launches, "long": lq.launches,
              "long_bwd": lq.bwd_launches, "default_cuda": default_attention.cuda_calls}
    if _TRACE:
        prof, path = _TRACE.pop("prof"), _TRACE.pop("path")
        _trace_stop(prof)
        hold_traced(prof, counts, f"{path} (traced counted run)", path)
    return counts


def _zero_counts(trace: str = None):
    """Set every launch count to 0. With ``trace`` (a counted path's name),
    the run from here to the next ``_counts()`` also runs under
    ``torch.profiler`` (the card's activity, no trace written; its times
    carry the profiler's cost), and that ``_counts()`` holds the launches
    the trace shows against the counters (``hold_traced``)."""
    from eoe_tpu_torch.ops import augment, cbam
    from eoe_tpu_torch.ops.attention import (default_attention, fused_qkv_attention as fq,
                                             flash_attention as fl, long_qkv_attention as lq)
    fq.launches = fq.bwd_launches = fq.group_launches = fq.group_bwd_launches = 0
    fq.resident_bwd_launches = fq.recompute_bwd_launches = 0
    fl.launches = fl.tc_launches = fl.tile_launches = 0
    augment.launches = augment.stats_launches = 0
    cbam.launches = cbam.bwd_launches = 0
    lq.launches = lq.bwd_launches = default_attention.cuda_calls = 0
    if trace is not None:
        check(not _TRACE, f"{trace}: the trace of {_TRACE.get('path')} was not ended")
        _TRACE.update(path=trace, prof=_trace_start())


def _trace_start():
    import torch
    from eoe_tpu_torch.utils.profiling import clear_spans
    clear_spans()   # the program's span records of the traces before
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _trace_stop(prof):
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    prof.stop()
    TRACE_SECONDS.append(time.perf_counter() - t0)


class _Traced:
    """Within: a part of a counted run of path ``path`` runs under
    ``torch.profiler`` as ``_zero_counts(path)`` runs a whole one, its
    trace held against the counters' increments over the part."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.before, self.prof = _counts(), _trace_start()

    def __exit__(self, exc_type, *exc):
        _trace_stop(self.prof)
        if exc_type is None:
            after = _counts()
            hold_traced(self.prof, {k: after[k] - self.before[k] for k in after},
                        f"{self.path} (traced part of a counted run)", self.path)


_TRACE = {}    # the running trace of a counted run: {"path": ..., "prof": ...}
# the traced launches of each traced run, by path: {path: {family: {"traced":
# n, "counted": m}}}, summed over the path's traced runs
TRACED = {}
TRACE_SECONDS = []   # host seconds of ending each trace and of reading it
# the port's kernels by the symbol a trace shows for each (the demangled
# name's identifier, in its source's anonymous namespace), in families by
# the counters that count their launches. One wrapper call launches one
# kernel. The fused kernels' grids share symbols (at d=128 a lane group is
# one head and takes the monolithic kernel), so a family sums both grids.
TRACED_FAMILIES = {
    "fused_qkv_fwd": (("fused_qkv_fwd_kernel", "fused_qkv_fwd_kernel_tc"), ("fwd", "group_fwd")),
    "fused_qkv_bwd": (("fused_qkv_bwd_kernel", "fused_qkv_bwd_kernel_tc",
                       "fused_qkv_bwd_group_kernel_tc"), ("bwd", "group_bwd")),
    "flash": (("flash_fwd_kernel", "flash_tc_kernel", "flash_tc_stream_kernel",
               "flash_tile_kernel", "flash_tile_stream_kernel"), ("flash",)),
    "augment_apply": (("augment_apply_kernel",), ("augment",)),
    "augment_stats": (("augment_stats_kernel",), ("augment_stats",)),
    # a CBAM wrapper's pool call launches its two stages, the others one kernel
    "cbam_fwd": (("cbam_channel_pool_kernel", "cbam_channel_pool_finish_kernel",
                  "cbam_spatial_pool_kernel", "cbam_gate_kernel"), ("cbam",)),
    "cbam_bwd": (("cbam_gate_bwd_kernel", "cbam_channel_bwd_kernel",
                  "cbam_channel_bwd_finish_kernel", "cbam_input_bwd_kernel"), ("cbam_bwd",)),
    # the long attention's backward launches its two kernels, one of each a call
    "long_fwd": (("long_fwd_kernel",), ("long",)),
    "long_bwd_dq": (("long_bwd_dq_kernel",), ("long_bwd",)),
    "long_bwd_dkdv": (("long_bwd_dkdv_kernel",), ("long_bwd",)),
}
# a kernel's identifier in a demangled device-event name: the first name
# followed by its template arguments or parameters that is unqualified or in
# an anonymous namespace (``void (anonymous namespace)::fused_qkv_fwd_kernel_tc
# <64, 1, 8>(...)``; a library's ``pytorch_flash::flash_fwd_kernel`` is none)
_SYMBOL = re.compile(r"(?:^|[\s*&])(?:\(anonymous namespace\)::)?([A-Za-z_]\w*)(?=[<(]|$)")


def kernel_symbol(name: str):
    m = _SYMBOL.search(name)
    return m.group(1) if m else None


def device_event_names(prof) -> list:
    """The demangled names of a finished profile's device events, read from
    the profiler's raw results: building its event list (``prof.events()``)
    takes most of a long trace's host time."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [torch._C._demangle(e.name()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def hold_traced(prof, counts: dict, what: str, path: str = None) -> dict:
    """The launches of each family of ``TRACED_FAMILIES`` among a finished
    profile's device events, held equal to the counters' ``counts`` over the
    same run; added to ``TRACED[path]`` with ``path``."""
    t0 = time.perf_counter()
    names = device_event_names(prof)
    seen = Counter(kernel_symbol(n) for n in names)
    TRACE_SECONDS.append(time.perf_counter() - t0)
    out = {fam: {"traced": sum(seen[s] for s in symbols),
                 "counted": sum(counts[k] for k in keys)}
           for fam, (symbols, keys) in TRACED_FAMILIES.items()}
    ours = {n[:120] for n in names
            if any(t in n for t in ("fused_qkv", "flash_", "augment_", "cbam_", "long_"))}
    check(all(v["traced"] == v["counted"] for v in out.values()),
          f"{what}: the trace's launches differ from the counters': {out}; device names "
          f"seen {sorted(ours)[:12]}")
    if path is not None:
        into = TRACED.setdefault(path, {fam: {"traced": 0, "counted": 0}
                                        for fam in TRACED_FAMILIES})
        for fam, v in out.items():
            for k in v:
                into[fam][k] += v[k]
    return out


FLASH_VARIANTS = {"flash_tc": "tensor cores", "flash_tile": "fp32 register tiles"}


def flash_variant(before: dict, after: dict) -> str:
    """The variant of the one flash launch between two ``_counts()``."""
    for key, name in FLASH_VARIANTS.items():
        if after[key] - before[key] == 1:
            return name
    return "CUDA cores"


BWD_DESIGNS = {"bwd_resident": "resident", "bwd_recompute": "recompute"}


def bwd_design(before: dict, after: dict) -> str:
    """The design of the fused backward launches between two ``_counts()``:
    fp32's resident or recompute design, or bf16's tensor cores."""
    for key, name in BWD_DESIGNS.items():
        if after[key] > before[key]:
            return name
    return "tensor cores"


AUGMENT_KEYS = ("augment", "augment_stats")
CBAM_KEYS = ("cbam", "cbam_bwd")
DEFAULT_KEYS = ("default_cuda",)   # default_attention's calls on the card


def check_counts(counts: dict, expected: dict, what: str):
    """Each kernel named in ``expected`` launched that many times, every
    other kernel not at all. The augmentation kernels are held only where
    ``expected`` names one of them (the paths whose pipeline calls are
    counted here: the training phases, ``augment_counts``), the CBAM kernels
    and ``default_attention``'s calls on the card likewise; elsewhere their
    launches are reported, and every traced run holds the kernels to the
    trace."""
    reported = {k for keys in (AUGMENT_KEYS, CBAM_KEYS, DEFAULT_KEYS)
                if not any(a in expected for a in keys) for k in keys}
    held = [k for k in counts if k not in reported]
    got = {k: counts[k] for k in held}
    want = {k: expected.get(k, 0) for k in held}
    check(got == want, f"{what}: launches {got}, expected {want}")


def augment_counts(calls: int, stats: bool) -> dict:
    """The augmentation launches of ``calls`` train-pipeline calls on a stack
    with a random crop: one apply each, and one stats where the crop step
    has a contrast factor or the guard."""
    return {"augment": calls, "augment_stats": calls if stats else 0}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``iters`` calls queued
    back to back behind a sleep kernel, over ``iters``. The queue keeps the
    host's time to issue a call (the wrapper's checks, the launch) out of the
    measurement, which a call of a few tens of microseconds would otherwise
    be made of."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)   # the device waits while the host queues the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(n, s, heads, d, causal, dtype, backward=False) -> tuple:
    """Least time for the function. Forward: read qkv (3 H d per row) once
    and write the output (H d) once; two products of 2 s^2 d operations per
    image and head. Backward: read qkv and dout, write d(qkv): 7 H d per row;
    five products (QK^T recomputed, dV, dP, dQ, dK). Causal rows need only
    their prefix of keys."""
    elem = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = n * s * (7 if backward else 4) * heads * d * elem
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = (10 if backward else 4) * n * heads * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    print(card)
    return card


def ptxas_summary(log: str) -> list:
    """One line per kernel of nvcc's ``-Xptxas=-v`` report: its name with
    its template arguments (element type, then the integers), registers and
    spill bytes."""
    import re
    lines, current, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"\d+([a-z][a-z_]*_kernel(?:_[a-z]+)?)I", mangled)
            args = ["bf16" if "bfloat16" in mangled else "fp32"] + re.findall(r"Li(\d+)E", mangled)
            if re.search(r"_kernelIh", mangled):
                args[0] = "u8"
            current, spills = f"{name.group(1) if name else mangled}<{', '.join(args)}>", ""
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = f"spill stores {spill.group(1)} B, loads {spill.group(2)} B"
        used = re.search(r"Used (\d+) registers", line)
        if used and current:
            lines.append(f"{current}: {used.group(1)} registers, {spills}")
    return lines


def phase_build():
    from eoe_tpu_torch.ops import _build, attention, augment, cbam
    sources = (attention.SOURCE, attention.FLASH_SOURCE, augment.SOURCE, cbam.SOURCE)

    def build(source):
        t0 = time.perf_counter()
        _build.build(source)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        seconds = list(pool.map(build, sources))
    attention._library()
    attention._flash_library()
    augment._library()
    cbam._library()
    print(f"build: {', '.join(f'{src} in {t:.1f} s' for src, t in zip(sources, seconds))}; "
          f"{time.perf_counter() - t0:.1f} s in all")
    for source in sources:
        for line in ptxas_summary(_build.build_log(source)):
            print(f"  ptxas {source}: {line}")


# (n, s, heads, d, causal): the ViT-B/32 image tower at the training and
# serving batch (n = 256 images), the text tower, a ragged causal case, d=128,
# the longest sequence at d=128 (where the fp32 backward recomputes P and dS),
# a sequence that fills its bf16 tiles, and one past the fp32 backward's
# resident design at d=64 (it recomputes P and dS)
SHAPES = [(256, 50, 12, 64, False), (64, 77, 8, 64, True),
          (3, 21, 4, 64, True), (2, 10, 2, 128, True), (2, 128, 2, 128, False),
          (4, 64, 12, 64, False), (2, 120, 4, 64, True)]
# a rank's heads under phase tp's model axis of two: the image tower's 6,
# the text tower's 4 (causal)
RANK_SHAPES = [(256, 50, 6, 64, False), (64, 77, 4, 64, True)]
SHAPES += RANK_SHAPES


def phase_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_fwd_ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for n, s, h, d, causal in SHAPES:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            out = fused_qkv_attention(qkv, h, causal)
            ref = fused_qkv_attention_fwd_ref(qkv, h, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tag = f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
            check(err <= tol, f"fused_qkv_attention {tag}: max abs err {err} > {tol}")
            q, k, v = (t.view(n, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            # a control: the library call differs from both in rounding, not in kind
            sdpa_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            sdpa_err = (sdpa_out.transpose(1, 2).reshape(out.shape).float()
                        - out.float()).abs().max().item()
            ms = time_ms(lambda: fused_qkv_attention(qkv, h, causal))
            plain_ms = time_ms(lambda: fused_qkv_attention_fwd_ref(qkv, h, causal))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            bound, by = attention_bound_ms(n, s, h, d, causal, dtype)
            rows[(n, s, h, d, causal, str(dtype))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=sdpa_ms, shape=tag)
            print(f"kernel fused_qkv_attention {tag}: max_abs_err {err:.3g} (tol {tol}; "
                  f"vs sdpa {sdpa_err:.3g}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}) [{card}]")
    return rows


def phase_kernels_bwd(card: str) -> dict:
    """The backward kernel against ``fused_qkv_attention_bwd_ref``. fp32: the
    two differ in summation order and in P's normalisation (by the reciprocal
    sum, not a division: an ulp of P), 2e-5 of the largest gradient. bf16:
    an order flip can move dS across a rounding boundary before the second
    products, and the output is rounded once more: 2^-5 of the largest. Each
    row names the design the launcher took; at CLIP's shapes fp32 must keep
    every tile resident."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import _bwd_kernel, fused_qkv_attention_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    for n, s, h, d, causal in SHAPES:
        for dtype, rel in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -5)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, s, h * d, generator=g, device="cuda").to(dtype)
            before = _counts()
            dqkv = _bwd_kernel(qkv, dout, h, causal)
            design = bwd_design(before, _counts())
            ref = fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
            torch.cuda.synchronize()
            err = (dqkv.float() - ref.float()).abs().max().item()
            tol = rel * ref.float().abs().max().item()
            tag = f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
            check(err <= tol, f"fused_qkv_attention backward {tag}: max abs err {err} > {tol}")
            check_design(tag, d, s, dtype, design)
            # the library yardstick: SDPA's backward through a retained forward
            q, k, v = (t.view(n, s, h, d).transpose(1, 2).detach().requires_grad_()
                       for t in qkv.chunk(3, dim=-1))
            sdpa_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            g_sdpa = dout.view(n, s, h, d).transpose(1, 2)
            ms = time_ms(lambda: _bwd_kernel(qkv, dout, h, causal))
            plain_ms = time_ms(lambda: fused_qkv_attention_bwd_ref(qkv, dout, h, causal))
            sdpa_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), g_sdpa,
                                                          retain_graph=True))
            bound, by = attention_bound_ms(n, s, h, d, causal, dtype, backward=True)
            rows[(n, s, h, d, causal, str(dtype))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=sdpa_ms, shape=tag, design=design)
            print(f"kernel fused_qkv_attention_bwd {tag} ({design}): max_abs_err {err:.3g} "
                  f"(tol {tol:.3g}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bwd {sdpa_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}) [{card}]")
    return rows


def check_design(tag: str, d: int, s: int, dtype, design: str):
    """At CLIP's shapes the fp32 backward keeps every tile resident; bf16
    runs on the tensor cores."""
    import torch
    if dtype == torch.bfloat16:
        check(design == "tensor cores", f"backward {tag} took the {design} design")
    elif d == 64 and s in (50, 77):
        check(design == "resident", f"backward {tag} took the {design} design, not resident")


def phase_kernels_group(card: str) -> tuple:
    """The lane-group kernels against the plain versions (the forward's and
    the backward's tolerances above) and against the monolithic kernels,
    which run the same per-head code: equal within the same tolerances (in
    practice bit for bit). Bound and yardstick as the monolithic rows."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import (
        _bwd_kernel, _fwd_kernel, _group_bwd_kernel, _group_fwd_kernel,
        fused_qkv_attention_bwd_ref, fused_qkv_attention_fwd_ref)

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    fwd_rows, bwd_rows = {}, {}
    for n, s, h, d, causal in SHAPES:
        for dtype, tol, rel in ((torch.float32, 2e-5, 2e-5), (torch.bfloat16, 2e-2, 2 ** -5)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, s, h * d, generator=g, device="cuda").to(dtype)
            tag = f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
            key = (n, s, h, d, causal, str(dtype))
            q, k, v = (t.view(n, s, h, d).transpose(1, 2).detach().requires_grad_()
                       for t in qkv.chunk(3, dim=-1))

            out = _group_fwd_kernel(qkv, h, causal)
            err = (out.float() - fused_qkv_attention_fwd_ref(qkv, h, causal).float()).abs().max().item()
            mono = (out.float() - _fwd_kernel(qkv, h, causal).float()).abs().max().item()
            check(err <= tol and mono <= tol, f"group forward {tag}: max abs err {err} against "
                  f"the plain version, {mono} against the monolithic kernel > {tol}")
            qd, kd, vd = (t.detach() for t in (q, k, v))
            ms = time_ms(lambda: _group_fwd_kernel(qkv, h, causal))
            plain_ms = time_ms(lambda: fused_qkv_attention_fwd_ref(qkv, h, causal))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal))
            bound, by = attention_bound_ms(n, s, h, d, causal, dtype)
            fwd_rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=sdpa_ms, shape=tag)
            print(f"kernel fused_qkv_attention_group {tag}: max_abs_err {err:.3g} (tol {tol}; "
                  f"vs monolithic {mono:.3g}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card}]")

            before = _counts()
            dqkv = _group_bwd_kernel(qkv, dout, h, causal)
            design = bwd_design(before, _counts())
            check_design(f"group {tag}", d, s, dtype, design)
            ref = fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
            btol = rel * ref.float().abs().max().item()
            err = (dqkv.float() - ref.float()).abs().max().item()
            mono = (dqkv.float() - _bwd_kernel(qkv, dout, h, causal).float()).abs().max().item()
            check(err <= btol and mono <= btol, f"group backward {tag}: max abs err {err} against "
                  f"the plain version, {mono} against the monolithic kernel > {btol}")
            sdpa_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            g_sdpa = dout.view(n, s, h, d).transpose(1, 2)
            ms = time_ms(lambda: _group_bwd_kernel(qkv, dout, h, causal))
            plain_ms = time_ms(lambda: fused_qkv_attention_bwd_ref(qkv, dout, h, causal))
            sdpa_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), g_sdpa,
                                                          retain_graph=True))
            bound, by = attention_bound_ms(n, s, h, d, causal, dtype, backward=True)
            bwd_rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=sdpa_ms, shape=tag, design=design)
            print(f"kernel fused_qkv_attention_group_bwd {tag} ({design}): max_abs_err {err:.3g} "
                  f"(tol {btol:.3g}; vs monolithic {mono:.3g}) kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa bwd {sdpa_ms:.4f} ms, bound {bound:.4f} ms ({by}) "
                  f"[{card}]")
    return fwd_rows, bwd_rows


# (n, heads, S, d, mask) of the flash kernel: the image tower at the serving
# and training batch, the text tower with its causal mask over the CIFAR-10
# prompts, the longest single block, the JAX tests' d=32 with a mask,
# d=128 with an arbitrary finite mask, and a head wider than one 256-column
# chunk
FLASH_SHAPES = [(256, 12, 50, 64, None), (10, 8, 77, 64, "causal"), (2, 12, 1024, 64, None),
                (2, 2, 77, 32, "causal"), (16, 8, 128, 128, "random"),
                (2, 2, 77, 300, "random")]


def flash_bound_ms(n, h, s, d, masked, dtype) -> tuple:
    """Least time for the function: read q, k, v and write the output once
    (4 n h S d elements), read the mask once (4 S^2 bytes); two products of
    2 S^2 d operations per (image, head). The mask is arbitrary, so every
    (query, key) pair counts."""
    elem = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = 4 * n * h * s * d * elem + (4 * s * s if masked else 0)
    ops = 4 * n * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels_flash(card: str) -> dict:
    """The flash kernel against ``flash_attention_ref``: fp32 within 2e-5
    (sum order only); bf16 within 2e-2 (an order flip can move P or the
    output across one bf16 rounding). Each row names the variant the
    launcher took; at CLIP's shapes bf16 must take the tensor cores and fp32
    the register tiles."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = {}
    for n, h, s, d, kind in FLASH_SHAPES:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.randn(n, h, s, d, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            mask = {None: None,
                    "causal": torch.full((s, s), float("-inf"), device="cuda").triu(1),
                    "random": torch.randn(s, s, generator=g, device="cuda")}[kind]
            before = _counts()
            out = flash_attention(q, k, v, mask)
            variant = flash_variant(before, _counts())
            err = (out.float() - flash_attention_ref(q, k, v, mask).float()).abs().max().item()
            tag = f"n={n} H={h} S={s} d={d} mask={kind} {str(dtype)[6:]}"
            check(err <= tol, f"flash_attention {tag}: max abs err {err} > {tol}")
            if d == 64 and s in (50, 77):
                want = "tensor cores" if dtype == torch.bfloat16 else "fp32 register tiles"
                check(variant == want, f"flash_attention {tag} took the {variant}, not the {want}")
            sdpa_mask = None if mask is None else mask.to(dtype)
            ms = time_ms(lambda: flash_attention(q, k, v, mask))
            plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, mask))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
            bound, by = flash_bound_ms(n, h, s, d, mask is not None, dtype)
            rows[(n, h, s, d, kind, str(dtype))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=sdpa_ms, shape=tag, variant=variant)
            print(f"kernel flash_attention {tag} ({variant}): max_abs_err {err:.3g} (tol {tol}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}) [{card}]")
    return rows


# ---------------------------------------------------------------- augmentation

# The crop steps of the three training stacks at their training shapes, one
# half-batch of BATCH raw images: the acceptance stack's
# color_jitter_crop_flip (256x256 -> 224, the guard, noise, CLIP's
# normalisation), the ImageNet-30 stack's flip-first random_crop_hflip
# (256x256 -> 224, the guard, normalize) and the CIFAR-10 stack's (32x32
# padded by 4 -> 32, noise, normalize; its jitter runs unfused before it, on
# the full image). ``normalize`` takes these statistics.
AUG_STATS = ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616))
AUG_STACKS = {
    "acceptance": dict(raw=256, size=224, padding=0, flip_first=False, guard=True, jitter=0.01,
                       noise=0.001, norm="clip"),
    "wrn": dict(raw=256, size=224, padding=0, flip_first=True, guard=True, jitter=None,
                noise=None, norm=AUG_STATS),
    "cifar": dict(raw=32, size=32, padding=4, flip_first=True, guard=False, jitter=None,
                  noise=0.001, norm=AUG_STATS),
}
# fp32 operations per output pixel of the apply kernel's chain, counted from
# its source: per channel the conversion (1), brightness (3), contrast (4),
# saturation (4), noise (2) and normalisation (2); per pixel the saturation's
# luma (5) and the hue's HSV round trip (~45)
AUG_OPS = {"convert": 1, "brightness": 3, "contrast": 4, "saturation": 4, "noise": 2, "norm": 2}
AUG_OPS_PIXEL = {"saturation": 5, "hue": 45}


def _aug_images(g, st, dtype):
    """BATCH raw images for a stack: random bytes, but image 0-3 near-white
    (254/255 with a textured 64x64 middle, the white border the guard is for;
    the jitter's brightness clip can make their crops constant), 4 and 5
    constant (255, 0) and 6 zero in its drawn crop window (set by the
    caller): the degenerate fallback's cases."""
    import torch
    raw = st["raw"]
    x = torch.randint(0, 256, (BATCH, raw, raw, 3), generator=g, device="cuda",
                      dtype=torch.uint8)
    x[:4] = 254 + torch.randint(0, 2, (4, raw, raw, 3), generator=g, device="cuda",
                                dtype=torch.uint8)
    a, e = raw // 2 - raw // 8, raw // 2 + raw // 8
    x[:4, a:e, a:e] = torch.randint(0, 256, (4, e - a, e - a, 3), generator=g, device="cuda",
                                    dtype=torch.uint8)
    x[4], x[5] = 255, 0
    return x if dtype == "uint8" else x.float() / 255.0


def _zero_window(x, tops, lefts, flip, flip_first, size, padding, b):
    """Zero image ``b`` inside its crop's source window (raw coordinates;
    flip -> crop takes a flipped image's crop from the mirrored window)."""
    raw = x.shape[1]
    left = int(lefts[b])
    if flip_first and bool(flip[b]):
        left = raw + 2 * padding - left - size
    t, l = int(tops[b]) - padding, left - padding
    x[b, max(t, 0):min(t + size, raw), max(l, 0):min(l + size, raw)] = 0


def _window_bytes(tops, lefts, raw, size, padding, elem) -> int:
    """Raw bytes inside the crop windows (the zero padding is not read)."""
    r0, c0 = (tops - padding).clamp(min=0), (lefts - padding).clamp(min=0)
    r1, c1 = (tops - padding + size).clamp(max=raw), (lefts - padding + size).clamp(max=raw)
    return int(((r1 - r0).clamp(min=0) * (c1 - c0).clamp(min=0)).sum().item()) * 3 * elem


def _bound(nbytes: int, ops: int) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["torch.float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _unfused_chain(st, x, tops, lefts, flip, jitter, noise, norm):
    """What the parent's pipeline ran for the stack's crop step: the unfused
    plain ops one after another (jitter on the full image, the flip of the
    full image or of the crop, the crop, noise, normalisation)."""
    from eoe_tpu_torch.ops import preprocess as P
    size = (st["size"],) * 2
    if jitter is not None:
        x = P.color_jitter(P._to_float(x), **jitter)
    if st["flip_first"]:
        x = P.random_hflip(x, flip)
    x = P.random_crop(x, tops, lefts, size, st["padding"], st["guard"])
    if not st["flip_first"]:
        x = P.random_hflip(x, flip)
    x = P._to_float(x)
    if noise is not None:
        x = P.gaussian_noise(x, noise, st["noise"])
    return P.normalize(x, *norm)


def phase_augment(card: str) -> dict:
    """Both augmentation kernels against their plain versions at the three
    stacks' crop steps, on uint8 and on fp32 input: the stats kernel's
    degenerate flags exactly and its contrast means to 1e-6; the apply
    kernel (from the plain stats) and the pair (``crop_augment``) to 1e-5 in
    [0, 1] units, 1e-5/std after the normalisation; on index-coded fp32
    images (each value its pixel's own, without jitter, noise or
    normalisation) the gathers exactly, the guard on. Times: each kernel,
    its plain version, and the whole step as kernels, as their plain
    version and as the parent's unfused plain ops. First each kernel's
    registers and spills, from the build's ptxas report."""
    import torch
    from eoe_tpu_torch.ops import _build
    from eoe_tpu_torch.ops import augment as A
    from eoe_tpu_torch.ops import preprocess as P

    for line in ptxas_summary(_build.build_log(A.SOURCE)):
        print(f"augment ptxas: {line}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = {}
    for name, st in AUG_STACKS.items():
        size, pad = (st["size"],) * 2, st["padding"]
        norm = (P.CLIP_MEAN, P.CLIP_STD) if st["norm"] == "clip" else st["norm"]
        tol = 1e-5 / min(norm[1])
        for dtype in ("uint8", "float32"):
            x = _aug_images(g, st, dtype)
            elem = x.element_size()
            d = P.draw_random_crop(x, g, size=size, padding=pad)
            tops, lefts = d["tops"], d["lefts"]
            flip = P.draw_random_hflip(x, g)["flip"]
            _zero_window(x, tops, lefts, flip, st["flip_first"], st["size"], pad, 6)
            jitter = None
            if st["jitter"]:
                jitter = P.draw_color_jitter(P._to_float(x), g, **dict.fromkeys(A.JITTER,
                                                                                st["jitter"]))
            noise = (torch.randn(BATCH, *size, 3, generator=g, device="cuda")
                     if st["noise"] else None)
            contrast = jitter is not None
            skw = dict(size=size, padding=pad, flip_first=st["flip_first"], contrast=contrast,
                       guard=st["guard"], brightness=jitter["brightness"] if contrast else None)
            akw = dict(size=size, padding=pad, flip_first=st["flip_first"], jitter=jitter,
                       noise=noise, noise_std=st["noise"] or 0.0, norm=norm)
            tag = f"{name} {dtype} ({BATCH}, {st['raw']}, {st['raw']}, 3) -> {size[0]}"

            # the stats kernel
            stats = contrast or st["guard"]
            if stats:
                mean_k, deg_k = A.crop_stats(x, tops, lefts, flip, **skw)
                mean_r, deg_r = A.crop_stats_ref(x, tops, lefts, flip, **skw)
                if st["guard"]:
                    check(torch.equal(deg_k, deg_r), f"augment stats {tag}: degenerate flags "
                          f"{deg_k.nonzero().flatten().tolist()} vs plain "
                          f"{deg_r.nonzero().flatten().tolist()}")
                    check(bool(deg_r[4:7].all()), f"augment stats {tag}: images 4-6 must be "
                          "degenerate")
                mean_err = (mean_k - mean_r).abs().max().item() if contrast else 0.0
                check(mean_err <= 1e-6, f"augment stats {tag}: contrast means differ by "
                      f"{mean_err}")
            else:
                mean_r = deg_r = None
            # the apply kernel, from the plain stats
            out_k = A.crop_apply(x, tops, lefts, flip, mean_r, deg_r, **akw)
            out_r = A.crop_apply_ref(x, tops, lefts, flip, mean_r, deg_r, **akw)
            apply_err = (out_k - out_r).abs().max().item()
            check(apply_err <= tol, f"augment apply {tag}: max abs err {apply_err} > {tol}")
            # the pair, against the JAX peephole's port
            step_k = A.crop_augment(x, tops, lefts, flip, guard=st["guard"], **akw)
            step_r = A.crop_augment_ref(x, tops, lefts, flip, guard=st["guard"], **akw)
            step_err = (step_k - step_r).abs().max().item()
            check(step_err <= tol and bool(torch.isfinite(step_k).all()),
                  f"augment step {tag}: max abs err {step_err} > {tol}")
            # the gathers: index-coded images, even images zero in their window
            raw = st["raw"]
            idx = torch.arange(raw * raw * 3, device="cuda", dtype=torch.float64)
            idx = (idx[None] + 7919 * torch.arange(BATCH, device="cuda")[:, None]) % 2 ** 24 + 1
            idx = idx.float().reshape(BATCH, raw, raw, 3)
            for b in range(0, BATCH, 2):
                _zero_window(idx, tops, lefts, flip, st["flip_first"], st["size"], pad, b)
            gkw = dict(size=size, padding=pad, flip_first=st["flip_first"], guard=True)
            gather_k = A.crop_augment(idx, tops, lefts, flip, **gkw)
            gather_r = A.crop_augment_ref(idx, tops, lefts, flip, **gkw)
            check(torch.equal(gather_k, gather_r), f"augment gathers {tag}: "
                  f"{(gather_k != gather_r).sum().item()} values differ")
            fell = A.crop_stats(idx, tops, lefts, flip, size=size, padding=pad,
                                flip_first=st["flip_first"], guard=True)[1]
            check(bool(fell[::2].all()) and not bool(fell[1::2].any()),
                  f"augment gathers {tag}: the zeroed windows must fall back, no other")

            # times (device, queued), bounds
            t = {}
            if stats:
                t["stats"] = time_ms(lambda: A.crop_stats(x, tops, lefts, flip, **skw))
                t["stats_plain"] = time_ms(lambda: A.crop_stats_ref(x, tops, lefts, flip,
                                                                    **skw))
            t["apply"] = time_ms(lambda: A.crop_apply(x, tops, lefts, flip, mean_r, deg_r, **akw))
            t["apply_plain"] = time_ms(lambda: A.crop_apply_ref(x, tops, lefts, flip, mean_r,
                                                                deg_r, **akw))
            t["step"] = time_ms(lambda: A.crop_augment(x, tops, lefts, flip, guard=st["guard"],
                                                       **akw))
            t["step_plain"] = time_ms(lambda: A.crop_augment_ref(x, tops, lefts, flip,
                                                                 guard=st["guard"], **akw))
            t["step_unfused"] = time_ms(lambda: _unfused_chain(st, x, tops, lefts, flip, jitter,
                                                               noise, norm))
            window = _window_bytes(tops, lefts, raw, st["size"], pad, elem)
            pixels = BATCH * size[0] * size[1]
            out_bytes = pixels * 3 * 4 * (2 if noise is not None else 1)   # noise in, out
            ops = pixels * (3 * (AUG_OPS["convert"] + AUG_OPS["norm"]
                                 + (AUG_OPS["noise"] if noise is not None else 0)
                                 + sum(AUG_OPS[k] for k in ("brightness", "contrast",
                                                            "saturation") if jitter))
                            + (sum(AUG_OPS_PIXEL.values()) if jitter else 0))
            stats_in = x.numel() * elem if contrast else window
            stats_bound = _bound(stats_in, 4 * x.numel() if contrast else x.numel())
            apply_bound = _bound(window + out_bytes, ops)
            step_bound = _bound(max(stats_in, window) + out_bytes, ops + 4 * x.numel())
            n_deg = int(deg_r.sum()) if deg_r is not None else 0
            rows[(name, dtype)] = {
                "stats": dict(max_abs_err=mean_err, ms=t["stats"], plain_ms=t["stats_plain"],
                              bound_ms=stats_bound[0], bound_by=stats_bound[1],
                              library_ms=None) if stats else None,
                "apply": dict(max_abs_err=apply_err, ms=t["apply"], plain_ms=t["apply_plain"],
                              bound_ms=apply_bound[0], bound_by=apply_bound[1],
                              library_ms=None),
                "step": dict(max_abs_err=step_err, ms=t["step"], plain_ms=t["step_plain"],
                             unfused_ms=t["step_unfused"], bound_ms=step_bound[0],
                             bound_by=step_bound[1]),
                "shape": tag, "degenerate": n_deg}
            stats_txt = (f"stats {t['stats']:.4f} ms (plain {t['stats_plain']:.4f}, bound "
                         f"{stats_bound[0]:.4f} {stats_bound[1]}, mean err {mean_err:.3g}); "
                         if stats else "no stats kernel; ")
            print(f"augment {tag}: {n_deg} degenerate; {stats_txt}apply {t['apply']:.4f} ms "
                  f"(plain {t['apply_plain']:.4f}, bound {apply_bound[0]:.4f} {apply_bound[1]}, "
                  f"err {apply_err:.3g}, tol {tol:.3g}); step {t['step']:.4f} ms (plain "
                  f"{t['step_plain']:.4f}, unfused plain {t['step_unfused']:.4f}, bound "
                  f"{step_bound[0]:.4f}, err {step_err:.3g}); gathers exact [{card}]")
            del x, idx, out_k, out_r, step_k, step_r, gather_k, gather_r, noise
            torch.cuda.empty_cache()
    return rows


CBAM_SHAPE = (256, 64, 56, 56)   # WideResNet's stage 1 at the benchmark's 128 + 128 rows


def _cbam_block_inputs(dtype, g):
    """A CBAM of stage 1's width computing in ``dtype``, in train mode (the
    spatial BN's scale drawn off its zero start, as the benchmark's weights
    are), and o, the residual and the output's gradient, NHWC in memory."""
    import torch
    from eoe_tpu_torch.models.cbam import CBAM
    n, c, h, w = CBAM_SHAPE
    m = CBAM(c, 16, dtype=dtype).cuda().train()
    with torch.no_grad():
        m.spatial_gate.spatial_bn.weight.fill_(0.8)

    def act():
        return torch.randn(n, h, w, c, generator=g, device="cuda").to(dtype).permute(0, 3, 1, 2)
    return m, act(), act(), act()


def phase_cbam(card: str) -> dict:
    """CBAM's kernels (``ops.cbam``, ``csrc/cbam.cu``) at WideResNet's stage-1
    shape (256, 64, 56, 56) in fp32 and bf16: K1-K3 and B1-B3 each against
    its plain version on the same inputs (maxima, tie counts, the residual's
    gradient exact; sums to 1e-5 of their largest value in fp32, 2^-7 in
    bf16), each timed beside its plain version and its bound (the bytes it
    must move over the HBM bandwidth); then a BasicBlock's whole CBAM and
    tail, forward and backward, through the kernels against the plain
    composition (``relu(cbam(o) + residual)`` under autograd): in fp32 the
    output as the kernels' sums, at most one ReLU in a million on the other
    side of 0, the gradients' relative L2 errors 1e-3; in bf16 (where the
    plain chain rounds after every op) the gradients against the same
    Functions with the plain versions, relative L2 2^-5, and both chains'
    distance from the fp32 chain reported; both timed, and the launches (4
    each way). First each kernel's registers and
    spills, from the build's ptxas report."""
    import copy
    import functools

    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops import _build
    from eoe_tpu_torch.ops import cbam as C

    for line in ptxas_summary(_build.build_log(C.SOURCE)):
        print(f"cbam ptxas: {line}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n, c, h, w = CBAM_SHAPE
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        m, o, r, gy = _cbam_block_inputs(dtype, g)
        a_bytes = o.numel() * o.element_size()
        pix = n * h * w
        cg = torch.rand(n, c, generator=g, device="cuda")
        sg = torch.rand(n, h * w, generator=g, device="cuda")
        gc = torch.randn(n, 2, h, w, generator=g, device="cuda").to(dtype)
        gmx, gavg = torch.randn_like(cg), torch.randn_like(cg)
        avg, mx, mx_ties = C.channel_pool(o)
        comp, cmax, ties = C.spatial_pool(o, cg)
        (y,) = C.gate(o, cg, sg, r)
        _, gx1, _ = C.gate_bwd(gy, y, o, cg, sg)
        # (name, kernel call, plain call, bytes it must move, outputs held exactly)
        cases = [
            ("channel_pool (K1)", lambda: C.channel_pool(o), lambda: C.channel_pool_ref(o),
             a_bytes, (1, 2)),
            ("spatial_pool (K2)", lambda: C.spatial_pool(o, cg),
             lambda: C.spatial_pool_ref(o, cg), a_bytes + pix * (2 * o.element_size() + 8),
             (1, 2)),
            ("gate (K3)", lambda: C.gate(o, cg, sg, r), lambda: C.gate_ref(o, cg, sg, r),
             3 * a_bytes, (0,) if dtype == torch.float32 else ()),
            ("gate_bwd (B1)", lambda: C.gate_bwd(gy, y, o, cg, sg),
             lambda: C.gate_bwd_ref(gy, y, o, cg, sg), 5 * a_bytes + 4 * pix, (0,)),
            ("channel_bwd (B2)", lambda: C.channel_bwd(gx1, o, cg, gc, cmax, ties),
             lambda: C.channel_bwd_ref(gx1, o, cg, gc, cmax, ties), 2 * a_bytes, ()),
            ("input_bwd (B3)",
             lambda: C.input_bwd(gx1, o, cg, gc, cmax, ties, mx, mx_ties, gmx, gavg),
             lambda: C.input_bwd_ref(gx1, o, cg, gc, cmax, ties, mx, mx_ties, gmx, gavg),
             3 * a_bytes, ()),
        ]
        kernels = {}
        for name, kern, plain, nbytes, exact in cases:
            got, want = kern(), plain()
            errs = []
            for i, (a, b) in enumerate(zip(got, want)):
                if i in exact:
                    check(torch.equal(a, b), f"cbam {name} {dtype}: output {i} differs from "
                          f"its plain version at {(a != b).sum().item()} places")
                    errs.append(0.0)
                else:
                    err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                    check(err <= tol, f"cbam {name} {dtype}: output {i} {err:.3g} of its max "
                          f"from its plain version (tol {tol:.3g})")
                    errs.append(err)
            kernels[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
                             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                             "max_rel_err": max(errs)}
        # a block's CBAM and tail, forward and backward, against the plain chain
        ref_m = copy.deepcopy(m)
        xi = o.detach().clone().requires_grad_()
        ri = r.detach().clone().requires_grad_()
        params, ref_params = list(m.parameters()), list(ref_m.parameters())

        def fused():
            return torch.autograd.grad(m.gate_tail(xi, ri), [xi, ri, *params], gy)

        def plain():
            return torch.autograd.grad(F.relu(ref_m(xi) + ri), [xi, ri, *ref_params], gy)

        check(m.takes_kernels(xi, ri), f"cbam {dtype}: the block does not take the kernels")
        before = (C.launches, C.bwd_launches)
        got, want = fused(), plain()
        launched = (C.launches - before[0], C.bwd_launches - before[1])
        check(launched == (4, 4), f"cbam {dtype}: a block launched {launched}, expected (4, 4)")
        with torch.no_grad():
            y_k, y_p = m.gate_tail(o, r), F.relu(ref_m(o) + r)
        y_err = ((y_k.float() - y_p.float()).abs().max() / y_p.float().abs().max()).item()
        flips = int(((y_k > 0) != (y_p > 0)).sum())
        names = ["o", "residual"] + [k for k, _ in m.named_parameters()]

        def rel_l2(xs, ys):
            return {k: ((a.float() - b.float()).norm() / b.float().norm()).item()
                    for k, a, b in zip(names, xs, ys)}
        # a ReLU whose input lies within a rounding of 0 may take the other
        # side (cg and sg differ in their last bits: the sums' order), and
        # moves whole values of the gradients there: relative L2 errors
        errs = rel_l2(got, want)
        chain_err = max(errs.values())
        if dtype == torch.float32:
            check(y_err <= tol and flips <= 1e-6 * y_p.numel() and chain_err <= 1e-3,
                  f"cbam {dtype}: the block's output {y_err:.3g} of its max from the plain "
                  f"chain's (tol {tol:.3g}), {flips} ReLUs on the other side; its gradients' "
                  f"relative L2 errors {errs} (tol 1e-3)")
            vs_fp32 = ""
        else:
            # the plain chain rounds to bf16 after every op, the kernels once:
            # the kernels held to the same Functions with their plain
            # versions (fp32 inside, as the kernels); both chains' distance
            # from the chain in fp32 on the same inputs reported
            orig = C.gate_tail
            C.gate_tail = functools.partial(orig, impl=C.REF)
            try:
                same = fused()
            finally:
                C.gate_tail = orig
            err_ref = rel_l2(got, same)
            check(max(err_ref.values()) <= 2.0 ** -5, f"cbam {dtype}: the kernels' gradients "
                  f"from their plain versions' (relative L2): {err_ref} (tol 2^-5)")
            ref32 = copy.deepcopy(ref_m)
            for mod in ref32.modules():
                if hasattr(mod, "dtype"):
                    mod.dtype = None
            x32, r32 = xi.detach().float().requires_grad_(), ri.detach().float().requires_grad_()
            exact = torch.autograd.grad(F.relu(ref32(x32) + r32),
                                        [x32, r32, *ref32.parameters()], gy.float())
            err_k, err_p = rel_l2(got, exact), rel_l2(want, exact)
            vs_fp32 = (f"; from their plain versions {max(err_ref.values()):.3g}; relative L2 "
                       f"from the fp32 chain, kernels {err_k}, plain chain {err_p}")
        with torch.no_grad():
            fwd_ms = time_ms(lambda: m.gate_tail(o, r), iters=10)
            fwd_plain = time_ms(lambda: F.relu(ref_m(o) + r), iters=10)
        both_ms, both_plain = time_ms(fused, iters=10), time_ms(plain, iters=10)
        chain_bytes = 7 * a_bytes   # read o, r, gy and o again; write y, go, the residual's
        row = {"shape": f"({n}, {h}, {w}, {c}) NHWC", "kernels": kernels,
               "chain_fwd_ms": fwd_ms, "chain_fwd_plain_ms": fwd_plain,
               "chain_ms": both_ms, "chain_plain_ms": both_plain,
               "chain_bound_ms": chain_bytes / HBM_BYTES_PER_S * 1e3,
               "chain_rel_l2_err": chain_err, "forward_rel_err": y_err, "relu_flips": flips,
               "launches": launched}
        rows[str(dtype)] = row
        txt = "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                        f"{v['bound_ms']:.4f}, err {v['max_rel_err']:.3g})"
                        for k, v in kernels.items())
        print(f"cbam {dtype} {row['shape']}: {txt}; block forward {fwd_ms:.4f} ms (plain "
              f"{fwd_plain:.4f}), forward + backward {both_ms:.4f} ms (plain {both_plain:.4f}, "
              f"the chain's bound {row['chain_bound_ms']:.4f}), forward err {y_err:.3g}, "
              f"gradients' relative L2 err {chain_err:.3g}{vs_fp32}, {flips} ReLU flips, "
              f"launches {launched} [{card}]")
        del m, ref_m, o, r, gy, xi, ri, got, want
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- long attention

# ViT-L/14's image tower in training: 128 + 128 rows, 257 tokens, 16 heads of 64
LONG_SHAPE = (256, 257, 16, 64)


def phase_long_attention(card: str) -> dict:
    """The long attention pair at ViT-L/14's training shape against its
    plain versions (output within 2e-2, a bf16 rounding; the backward, from
    the kernel's own output and statistics, within 2^-5 of its largest
    value, as the fused backward's card test), timed: the forward kernel,
    the backward's two kernels, their bounds (``attention_bound_ms``), the
    plain versions on the card and autograd of ``default_attention``."""
    import torch
    from eoe_tpu_torch.ops import attention as A

    n, s, h, d = LONG_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").bfloat16()
    dout = torch.randn(n, s, h * d, generator=g, device="cuda").bfloat16()
    out, stats = A._long_fwd_kernel(qkv, h)
    ref, _ = A.long_qkv_attention_fwd_ref(qkv, h)
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= 2e-2, f"long_qkv_attention forward: max abs err {err}")
    dqkv = A._long_bwd_kernel(qkv, out, stats, dout, h)
    dref = A.long_qkv_attention_bwd_ref(qkv, out, stats, dout, h)
    berr = (dqkv.float() - dref.float()).abs().max().item()
    btol = 2 ** -5 * dref.float().abs().max().item()
    check(berr <= btol, f"long_qkv_attention backward: max abs err {berr} > {btol}")
    check(torch.equal(dqkv, A._long_bwd_kernel(qkv, out, stats, dout, h)),
          "long_qkv_attention backward: two runs differ")
    del ref, dref

    def plain_pair():
        x = qkv.detach().requires_grad_(True)
        q, k, v = (t.reshape(n, s, h, d).transpose(1, 2) for t in x.chunk(3, dim=-1))
        A.default_attention(q, k, v, None).transpose(1, 2).reshape(n, s, h * d).backward(dout)

    fwd_ms = time_ms(lambda: A._long_fwd_kernel(qkv, h))
    bwd_ms = time_ms(lambda: A._long_bwd_kernel(qkv, out, stats, dout, h))
    plain_fwd = time_ms(lambda: A.long_qkv_attention_fwd_ref(qkv, h), iters=5)
    plain_bwd = time_ms(lambda: A.long_qkv_attention_bwd_ref(qkv, out, stats, dout, h), iters=5)
    default_ms = time_ms(plain_pair, iters=5)
    rows = {}
    for key, ms, plain, backward, e in (("fwd", fwd_ms, plain_fwd, False, err),
                                        ("bwd", bwd_ms, plain_bwd, True, berr)):
        bound, by = attention_bound_ms(n, s, h, d, False, "torch.bfloat16", backward)
        rows[key] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, max_abs_err=e,
                         roofline_pct=100 * bound / ms, shape=f"n={n} s={s} H={h} d={d} bf16")
        print(f"kernel long_qkv_attention {key} n={n} s={s} H={h} d={d} bf16: max_abs_err "
              f"{e:.3g} kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of it [{card}]")
    print(f"long_qkv_attention: default_attention forward + backward under autograd "
          f"{default_ms:.4f} ms against the pair's {fwd_ms + bwd_ms:.4f} ms [{card}]")
    rows["default_ms"] = default_ms
    return rows


def phase_vitl14(card: str) -> dict:
    """ViT-L/14 at its published widths trained in bf16 (the HSC objective,
    the acceptance stack, 128 + 128 a step, the resident epoch's graphs),
    counted and traced: 24 long forward and backward launches a step, 24
    forward a test batch, no call of ``default_attention`` on the card; the
    step's memory peak."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_L14

    layers = VIT_L14.vision_layers
    data = _combined(np.random.default_rng(SEED), ACCEPTANCE_SPECS)
    torch.cuda.reset_peak_memory_stats()
    counts = _train_bf16(card, "vitl14", "vitl14_training",
                         CLIP(VIT_L14, dtype=torch.bfloat16), data, 1,
                         lambda steps, evals: {"long": layers * (steps + evals),
                                               "long_bwd": layers * steps, "default_cuda": 0},
                         model_name="ViT-L/14")
    peak = torch.cuda.max_memory_allocated()
    print(f"vitl14: memory peak {peak} bytes ({peak / 2 ** 30:.2f} GiB) of train_cls and "
          f"eval_cls at {BATCH} + {BATCH} [{card}]")
    counts["peak_bytes"] = peak
    return counts


def phase_slice(card: str) -> dict:
    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops import metrics
    from eoe_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_ref
    from eoe_tpu_torch.ops.preprocess import compile_pipeline
    from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

    specs = [{"op": "clip_pil_preprocessing", "resolution": VIT_B32.image_resolution},
             {"op": "clip_tensor_preprocessing"}]
    t0 = time.perf_counter()
    model = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.to("cuda")
    print(f"slice: ViT-B/32 ({sum(p.numel() for p in model.parameters())} params) "
          f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8) for n in REQUESTS]
    snapshot = {"params": state, "setup": {"test_specs": specs}}

    # warm-up of the library calls around the kernel, outside the counted run
    warm = AnomalyScorer(snapshot, model, objective="hsc", batch_size=BATCH)
    warm.score(requests[-1])
    torch.cuda.synchronize()

    # ---- the main path, counted
    _zero_counts("serving")
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    prompt_launches = fused_qkv_attention.launches
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH, center=center)
    scores, seconds = [], []
    for images in requests:
        t0 = time.perf_counter()
        scores.append(scorer.score(images))  # ends in a device->host copy
        seconds.append(time.perf_counter() - t0)
    counts = _counts()
    # ---- end of the counted run
    launches = counts["fwd"]

    batches = sum(-(-n // BATCH) for n in REQUESTS)
    layers = VIT_B32.vision_layers
    check(prompt_launches == VIT_B32.transformer_layers,
          f"prompt centre launched the kernel {prompt_launches} times, "
          f"expected {VIT_B32.transformer_layers}")
    check_counts(counts, {"fwd": prompt_launches + layers * batches},
                 f"serving ({layers} x {batches} batches after the prompts)")
    for n, sc in zip(REQUESTS, scores):
        check(sc.shape == (n,) and np.isfinite(sc).all(), f"request of {n}: bad scores")
        check(((sc >= 0) & (sc <= 1)).all(), f"request of {n}: scores outside [0, 1]")

    # the same model through the kernel's plain version, chosen explicitly
    ref_model = CLIP(VIT_B32, qkv_attention=fused_qkv_attention_ref).to("cuda")
    ref_model.load_state_dict(state)
    ref_center = prompt_center(ref_model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    center_err = (center - ref_center).abs().max().item()
    ref_scorer = AnomalyScorer(snapshot, ref_model, objective="clip", batch_size=BATCH,
                               center=ref_center)
    score_err = max(float(np.abs(sc - ref_scorer.score(im)).max())
                    for sc, im in zip(scores, requests))
    check(score_err <= 1e-4, f"fp32 scores differ from the plain-attention run by {score_err}")
    labels = np.arange(REQUESTS[0]) % 2  # synthetic: checks the plumbing only
    auc = metrics.auroc(labels, scores[0])
    print(f"slice clip fp32: prompt centre err {center_err:.3g}, score err {score_err:.3g} "
          f"(tol 1e-4), score range [{min(s.min() for s in scores):.4f}, "
          f"{max(s.max() for s in scores):.4f}], synthetic AUROC {auc:.4f}")
    print(f"slice clip fp32: {REQUESTS[0]} images in {seconds[0] * 1e3:.1f} ms = "
          f"{REQUESTS[0] / seconds[0]:.1f} img/s; requests {list(REQUESTS)} took "
          f"{[round(t * 1e3, 1) for t in seconds]} ms [{card}]")

    # HSC in bf16, one request, held against the plain version in bf16
    bf = CLIP(VIT_B32, dtype=torch.bfloat16)
    bf_ref = CLIP(VIT_B32, dtype=torch.bfloat16, qkv_attention=fused_qkv_attention_ref)
    hsc_scorer = AnomalyScorer(snapshot, bf, objective="hsc", batch_size=BATCH,
                               compute_dtype=torch.bfloat16)
    hsc_scorer.score(requests[2])  # warm-up of the bf16 library calls
    fused_qkv_attention.launches = 0
    t0 = time.perf_counter()
    hsc = hsc_scorer.score(requests[1])
    hsc_seconds = time.perf_counter() - t0
    hsc_launches = fused_qkv_attention.launches
    hsc_ref = AnomalyScorer(snapshot, bf_ref, objective="hsc", batch_size=BATCH,
                            compute_dtype=torch.bfloat16).score(requests[1])
    hsc_expected = layers * -(-REQUESTS[1] // BATCH)
    check(hsc_launches == hsc_expected,
          f"hsc bf16 request launched the kernel {hsc_launches} times, expected {hsc_expected}")
    check(np.isfinite(hsc).all() and ((hsc >= 0) & (hsc <= 1)).all(), "hsc bf16: bad scores")
    with torch.inference_mode():
        x = torch.from_numpy(requests[1]).cuda()
        x = compile_pipeline(specs)(x).to(torch.bfloat16)
        feat_err = (bf(x).float() - bf_ref(x).float()).abs().max().item()
    check(feat_err <= 0.1, f"hsc bf16: features differ from the plain version by {feat_err}")
    print(f"slice hsc bf16: {REQUESTS[1]} images in {hsc_seconds * 1e3:.1f} ms, score err "
          f"{np.abs(hsc - hsc_ref).max():.3g}, feature err {feat_err:.3g} (tol 0.1), score "
          f"range [{hsc.min():.6f}, {hsc.max():.6f}] [{card}]")
    return counts


# the acceptance augmentation stack of the JAX package's training benchmark
# (bench.py:60-68: the reference CLIP fine-tune stack)
ACCEPTANCE_SPECS = [
    {"op": "resize", "size": 256},
    {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
     "hue": 0.01},
    {"op": "random_crop", "size": 224, "resample_degenerate": True},
    {"op": "random_hflip", "p": 0.5},
    {"op": "clip_pil_preprocessing"},
    {"op": "gaussian_noise", "std": 0.001},
    {"op": "clip_tensor_preprocessing"}]
CLIP_TEST_SPECS = [{"op": "clip_pil_preprocessing"}, {"op": "clip_tensor_preprocessing"}]
TRAIN_N, TRAIN_OE, TRAIN_TEST, TRAIN_HW, TRAIN_EPOCHS = 512, 512, 256, 256, 2
# train-pipeline calls besides the steps' two halves: the preview the first
# seed of a class writes, one call per half
PREVIEW_CALLS = 2


def _combined(rng, train_specs):
    """512 normal + 512 OE + 256 test raw uint8 images; test labels alternate
    normal / anomalous (synthetic: they check the plumbing only)."""
    import numpy as np
    from eoe_tpu_torch.datasets.bases import ArraySource, CombinedDataset, GenericADDataset
    hw = TRAIN_HW
    x = rng.integers(0, 256, (TRAIN_N, hw, hw, 3), dtype=np.uint8)
    xo = rng.integers(0, 256, (TRAIN_OE, hw, hw, 3), dtype=np.uint8)
    xt = rng.integers(0, 256, (TRAIN_TEST, hw, hw, 3), dtype=np.uint8)
    kw = dict(root="", train_specs=train_specs, test_specs=CLIP_TEST_SPECS, n_classes=2,
              raw_shape=(hw, hw, 3))
    normal = GenericADDataset(ArraySource(x, np.zeros(TRAIN_N)),
                              ArraySource(xt, np.arange(TRAIN_TEST) % 2),
                              normal_classes=(0,), nominal_label=0, **kw)
    oe = GenericADDataset(ArraySource(xo, np.ones(TRAIN_OE)), None,
                          normal_classes=(1,), nominal_label=1, **kw)
    return CombinedDataset(normal, oe), xt


def _trainer(model, train_specs, logger, dtype, epochs=TRAIN_EPOCHS):
    """The JAX package's benchmark trainer (bench.py:123-127)."""
    from eoe_tpu_torch.training import TRAINER
    return TRAINER["hsc"](model=model, train_specs=train_specs, test_specs=CLIP_TEST_SPECS,
                          dataset="cifar10", oe_dataset="cifar100", datapath="", logger=logger,
                          epochs=epochs, lr=1e-4, wdk=1e-3, milestones=[],
                          batch_size=BATCH, compute_dtype=dtype)


def _train_bf16(card, label, trace, model, data, epochs, expected, serve_model=None,
                model_name="ViT-B/32") -> dict:
    """``train_cls`` of ``epochs`` epochs and ``eval_cls`` on the acceptance
    set, counted: ``expected(steps, eval_batches)`` gives each attention
    kernel's launches; the augmentation kernels launch twice for each
    train-pipeline call (the stats for the contrast mean and the guard).
    With ``serve_model``, the snapshot is served back through
    ``AnomalyScorer`` and held against ``eval_cls``'s scores. ``trace``: the
    counted path's name (traced)."""
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.utils.logger import Logger

    ds, x_test = data
    steps = epochs * (TRAIN_N // BATCH)
    eval_batches = -(-TRAIN_TEST // BATCH)
    with tempfile.TemporaryDirectory() as logdir:
        trainer = _trainer(model, ACCEPTANCE_SPECS, Logger(logdir, noname=True), torch.bfloat16,
                           epochs)
        trainer.ds = ds

        # ---- the main path, counted: train_cls, eval_cls, snapshot
        _zero_counts(trace)
        t0 = time.perf_counter()
        state, roc = trainer.train_cls(ds, 0, "airplane", 0, seed=SEED)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        eroc, _ = trainer.eval_cls(state, ds, 0, "airplane", 0)
        t_eval = time.perf_counter() - t0
        path = trainer.snapshot("snapshot_cls0_it0", state, epochs, ds.ds_statistics)
        trainer.logger.drain()   # the snapshot is written in the background
        counts = _counts()
        # ---- end of the counted run

        losses = trainer.step_losses
        check(len(losses) == steps and np.isfinite(losses).all(),
              f"{label}: expected {steps} finite losses, got {losses}")
        check_counts(counts, {**expected(steps, eval_batches),
                              **augment_counts(2 * steps + PREVIEW_CALLS, stats=True)},
                     f"{label} ({steps} steps, {eval_batches} eval batches)")
        eval_scores = np.array([v for _, v in sorted(
            (int(k), v) for k, v in _read_json(logdir, "eval_cls0_it0_anomaly_scores").items())])
        check(eval_scores.shape == (TRAIN_TEST,) and np.isfinite(eval_scores).all(),
              f"{label}: eval_cls gave bad scores")
        rates = [round(r, 1) for r in trainer.epoch_rates]
        print(f"{label} hsc bf16 {model_name}: {steps} steps of {BATCH}+{BATCH} images in "
              f"{t_train:.2f} s; img/s per epoch {rates}; losses "
              f"{[round(x, 5) for x in losses]}; train AUROC {roc.auc:.4f}, eval of "
              f"{TRAIN_TEST} in {t_eval:.2f} s, synthetic AUROC {eroc.auc:.4f}; launches "
              f"{counts} [{card}]")

        if serve_model is not None:
            scorer = AnomalyScorer(path, serve_model, objective="hsc", batch_size=BATCH,
                                   compute_dtype=torch.bfloat16)
            _zero_counts()
            served = scorer.score(x_test)
            served_counts = _counts()
            serve_err = float(np.abs(served - eval_scores).max())
            check(serve_err <= 1e-4, f"{label}: served snapshot differs from eval_cls by "
                  f"{serve_err}")
            print(f"{label}: snapshot served through AnomalyScorer, max score difference to "
                  f"eval_cls {serve_err:.3g} (tol 1e-4); launches {served_counts}")
            counts["served"] = served_counts
    del trainer, state
    torch.cuda.empty_cache()
    return counts


def _train_steps(model, ds32, dtype=None, steps=3, path=None) -> tuple:
    """``steps`` HSC steps (deterministic pipeline) from seed 0 in ``dtype``
    (fp32 by default), counted (traced as ``path`` where given): losses, the
    first step's visual gradients, the visual parameters after, and every
    kernel's launches."""
    import torch
    tr = _trainer(model, CLIP_TEST_SPECS, None, dtype or torch.float32)
    st = tr.init_state(SEED, ds32, 1)
    dev = tr.device
    xn = torch.from_numpy(ds32.train_set.gather_all()).to(dev)
    xo = torch.from_numpy(ds32.oe.train_set.gather_all()).to(dev)
    ln = torch.zeros(TRAIN_N, dtype=torch.int64, device=dev)
    lo = torch.ones(TRAIN_OE, dtype=torch.int64, device=dev)
    w = torch.ones(BATCH, device=dev)
    visual = [p for p in st.model.visual.parameters()]
    _zero_counts(path)
    losses, grads = [], None
    for i in range(steps):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        loss, *_ = tr.train_step(st, ds32, xn[sl], ln[sl], xo[sl], lo[sl], w, None)
        losses.append(loss.item())
        if i == 0:
            grads = [p.grad.clone() for p in visual]
    counts = _counts()
    params = [p.detach().clone() for p in visual]
    del tr, st, visual
    torch.cuda.empty_cache()
    return losses, grads, params, counts


def _hold_fp32(card, label, run, control):
    """A 3-step fp32 run against its control: first-step gradients within
    1e-4 of their max, losses within 1e-5 (relative), visual parameters
    within 1e-5."""
    (lk, gk, pk, _), (lp, gp, pp, _) = run, control
    g_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(gk, gp))
    l_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    p_err = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    check(g_err <= 1e-4, f"{label}: fp32 first-step gradients differ by {g_err} of their max")
    check(l_err <= 1e-5, f"{label}: fp32 losses differ by {l_err} (relative)")
    check(p_err <= 1e-5, f"{label}: fp32 visual parameters differ by {p_err} after 3 steps")
    print(f"{label}, 3 steps: gradient err {g_err:.3g} of max (tol 1e-4), loss err "
          f"{l_err:.3g} rel (tol 1e-5), parameter err {p_err:.3g} (tol 1e-5); losses "
          f"{[round(x, 6) for x in lk]} [{card}]")


def _fp32_data():
    import numpy as np
    return _combined(np.random.default_rng(SEED + 1), CLIP_TEST_SPECS)[0]


def phase_train(card: str, data) -> tuple:
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops.attention import fused_qkv_attention_ref

    layers = VIT_B32.vision_layers
    counts = _train_bf16(card, "train", "training", CLIP(VIT_B32, dtype=torch.bfloat16), data,
                         TRAIN_EPOCHS,
                         lambda steps, evals: {"fwd": layers * (steps + evals),
                                               "bwd": layers * steps},
                         serve_model=CLIP(VIT_B32, dtype=torch.bfloat16))

    # fp32, deterministic pipeline: the kernels against their plain versions
    ds32 = _fp32_data()
    run = _train_steps(CLIP(VIT_B32), ds32, path="training_fp32")
    check_counts(run[3], {"fwd": 3 * layers, "bwd": 3 * layers, "bwd_resident": 3 * layers},
                 "fp32 kernel run")
    fp32_counts = run[3]
    control = _train_steps(CLIP(VIT_B32, qkv_attention=fused_qkv_attention_ref), ds32)
    check_counts(control[3], {}, "fp32 plain run")
    _hold_fp32(card, "train hsc fp32 kernels vs plain", run, control)
    del run, control

    # the bf16 hold: one bf16 step through the kernels and through their
    # plain versions, from the same weights on the same batch
    run = _train_steps(CLIP(VIT_B32, dtype=torch.bfloat16), ds32, torch.bfloat16, steps=1)
    check_counts(run[3], {"fwd": layers, "bwd": layers}, "bf16 kernel step")
    control = _train_steps(CLIP(VIT_B32, dtype=torch.bfloat16,
                               qkv_attention=fused_qkv_attention_ref), ds32, torch.bfloat16,
                          steps=1)
    check_counts(control[3], {}, "bf16 plain step")
    _hold_bf16(card, run, control)
    return counts, fp32_counts


# The bf16 hold's limits. The kernels and their plain versions round P, dS and
# the outputs to bf16 at the same places but sum in other orders, so single
# elements differ by a bf16 ulp (2^-8 relative) where a sum lands near a
# rounding boundary; through 12 layers forward and back such flips move the
# loss by well under 2^-8 and a gradient by a few ulps of its tensor's max. A
# wrong mask, scale or transpose moves both by order 1.
BF16_LOSS_TOL, BF16_GRAD_TOL = 2 ** -8, 2 ** -4


def _hold_bf16(card, run, control):
    """One bf16 step against its control: the loss within ``BF16_LOSS_TOL``
    (relative), the visual gradients within ``BF16_GRAD_TOL`` of each
    tensor's max."""
    (lk, gk, _, _), (lp, gp, _, _) = run, control
    l_err = abs(lk[0] - lp[0]) / abs(lp[0])
    g_err = max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
                .item() for a, b in zip(gk, gp))
    check(l_err <= BF16_LOSS_TOL, f"bf16 hold: losses differ by {l_err} (relative)")
    check(g_err <= BF16_GRAD_TOL, f"bf16 hold: first-step gradients differ by {g_err} of max")
    print(f"train hsc bf16 kernels vs plain, 1 step: loss {lk[0]:.6f} vs {lp[0]:.6f}, err "
          f"{l_err:.3g} rel (tol {BF16_LOSS_TOL:.3g}), gradient err {g_err:.3g} of max (tol "
          f"{BF16_GRAD_TOL:.3g}) [{card}]")


def phase_flash(card: str, data) -> tuple:
    """The flash path: serving and training through ``CLIP(attention_fn=
    flash_attention)``, each held in fp32 against ``default_attention``."""
    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops.attention import default_attention, flash_attention
    from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

    specs = [{"op": "clip_pil_preprocessing", "resolution": VIT_B32.image_resolution},
             {"op": "clip_tensor_preprocessing"}]
    model = CLIP(VIT_B32, attention_fn=flash_attention,
                 generator=torch.Generator().manual_seed(SEED))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.to("cuda")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8) for n in REQUESTS]
    snapshot = {"params": state, "setup": {"test_specs": specs}}
    AnomalyScorer(snapshot, model, objective="hsc", batch_size=BATCH).score(requests[-1])
    torch.cuda.synchronize()

    # ---- the flash serving path, counted
    _zero_counts("flash_serving")
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    prompt_launches = flash_attention.launches
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH, center=center)
    scores, seconds = [], []
    for images in requests:
        t0 = time.perf_counter()
        scores.append(scorer.score(images))
        seconds.append(time.perf_counter() - t0)
    serving = _counts()
    # ---- end of the counted run

    batches = sum(-(-n // BATCH) for n in REQUESTS)
    text, layers = VIT_B32.transformer_layers, VIT_B32.vision_layers
    check(prompt_launches == text, f"flash prompt centre: {prompt_launches} launches, "
          f"expected {text}")
    launched = text + layers * batches     # fp32: every launch on the register tiles
    check_counts(serving, {"flash": launched, "flash_tile": launched},
                 f"flash serving ({text} for the prompts, {layers} x {batches} batches)")
    for n, sc in zip(REQUESTS, scores):
        check(sc.shape == (n,) and np.isfinite(sc).all() and ((sc >= 0) & (sc <= 1)).all(),
              f"flash request of {n}: bad scores")
    ref_model = CLIP(VIT_B32, attention_fn=default_attention).to("cuda")
    ref_model.load_state_dict(state)
    ref_center = prompt_center(ref_model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    ref_scorer = AnomalyScorer(snapshot, ref_model, objective="clip", batch_size=BATCH,
                               center=ref_center)
    score_err = max(float(np.abs(sc - ref_scorer.score(im)).max())
                    for sc, im in zip(scores, requests))
    check(score_err <= 1e-4, f"flash fp32 scores differ from default_attention's by {score_err}")
    print(f"flash serving clip fp32: prompt centre err "
          f"{(center - ref_center).abs().max().item():.3g}, score err {score_err:.3g} (tol "
          f"1e-4); {REQUESTS[0]} images in {seconds[0] * 1e3:.1f} ms = "
          f"{REQUESTS[0] / seconds[0]:.1f} img/s; requests {list(REQUESTS)} took "
          f"{[round(t * 1e3, 1) for t in seconds]} ms; launches {serving} [{card}]")
    del model, ref_model, scorer, ref_scorer
    torch.cuda.empty_cache()

    # bf16: every launch on the tensor cores
    training = _train_bf16(card, "flash train", "flash_training",
                           CLIP(VIT_B32, dtype=torch.bfloat16, attention_fn=flash_attention),
                           data, 1, lambda steps, evals: {"flash": layers * (steps + evals),
                                                          "flash_tc": layers * (steps + evals)})
    ds32 = _fp32_data()
    run = _train_steps(CLIP(VIT_B32, attention_fn=flash_attention), ds32)
    check_counts(run[3], {"flash": 3 * layers, "flash_tile": 3 * layers}, "flash fp32 kernel run")
    control = _train_steps(CLIP(VIT_B32, attention_fn=default_attention), ds32)
    check_counts(control[3], {}, "flash fp32 default_attention run")
    _hold_fp32(card, "flash train hsc fp32 flash vs default_attention", run, control)
    return serving, training


def phase_group(card: str, data) -> tuple:
    """The lane-group grid, chosen as the JAX package chooses it, through
    training, eval and serving; held in fp32 against the monolithic grid.
    Returns the bf16 path's counts and the fp32 steps'."""
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops import attention

    layers = VIT_B32.vision_layers
    saved = attention.GROUP_GRID
    try:
        attention.GROUP_GRID = True
        training = _train_bf16(card, "group train", "group_training",
                               CLIP(VIT_B32, dtype=torch.bfloat16), data, 1,
                               lambda steps, evals: {"group_fwd": layers * (steps + evals),
                                                     "group_bwd": layers * steps},
                               serve_model=CLIP(VIT_B32, dtype=torch.bfloat16))
        check_counts(training.pop("served"), {"group_fwd": layers * -(-TRAIN_TEST // BATCH)},
                     "group serving")
        ds32 = _fp32_data()
        run = _train_steps(CLIP(VIT_B32), ds32, path="group_training_fp32")
        check_counts(run[3], {"group_fwd": 3 * layers, "group_bwd": 3 * layers,
                              "bwd_resident": 3 * layers}, "group fp32 kernel run")
        fp32_counts = run[3]
        attention.GROUP_GRID = False
        control = _train_steps(CLIP(VIT_B32), ds32)
        check_counts(control[3], {"fwd": 3 * layers, "bwd": 3 * layers,
                                  "bwd_resident": 3 * layers}, "monolithic fp32 kernel run")
        _hold_fp32(card, "group train hsc fp32 group grid vs monolithic", run, control)
    finally:
        attention.GROUP_GRID = saved
    return training, fp32_counts


# ---------------------------------------------------------------- conv models

# the reference CIFAR-10 stack of the JAX package's benchmark (bench.py:91-103)
CIFAR_SPECS = [
    {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
     "hue": 0.01},
    {"op": "random_hflip", "p": 0.5},
    {"op": "random_crop", "size": 32, "padding": 4},
    {"op": "gaussian_noise", "std": 0.001},
    "normalize"]
# the reference ImageNet-30 stack of the same benchmark (bench.py:71-90)
WRN_SPECS = [
    {"op": "resize", "size": 256},
    {"op": "random_hflip", "p": 0.5},
    {"op": "random_crop", "size": 224, "resample_degenerate": True},
    "normalize"]
WRN_TEST_SPECS = [{"op": "resize", "size": 256}, {"op": "center_crop", "size": 224}, "normalize"]
CONV_N, CONV_TEST, CONV_EPOCHS = 2048, 256, 2      # CNN32: bench.py uses 8192 and 8 epochs
WRN_N, WRN_TEST, WRN_EPOCHS = 512, 128, 2          # WideResNet: bench.py uses 2048 and 6


def _pinned(rng, hw, n, n_test, train_specs, test_specs):
    """``n`` normal + ``n`` OE + ``n_test`` test raw uint8 images of hw x hw;
    test labels alternate normal / anomalous. The ``normalize`` placeholder
    takes each split's statistics, as in the JAX package's benchmark."""
    import numpy as np
    from eoe_tpu_torch.datasets.bases import ArraySource, CombinedDataset, GenericADDataset
    x = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    xo = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    xt = rng.integers(0, 256, (n_test, hw, hw, 3), dtype=np.uint8)
    kw = dict(root="", train_specs=train_specs, test_specs=test_specs, n_classes=2,
              raw_shape=(hw, hw, 3))
    normal = GenericADDataset(ArraySource(x, np.zeros(n)), ArraySource(xt, np.arange(n_test) % 2),
                              normal_classes=(0,), nominal_label=0, **kw)
    oe = GenericADDataset(ArraySource(xo, np.ones(n)), None, normal_classes=(1,),
                          nominal_label=1, **kw)
    return CombinedDataset(normal, oe), xt


def _conv_trainer(objective, model, train_specs, test_specs, logger, dtype, epochs,
                  datapath=""):
    """The JAX package's benchmark trainer settings (bench.py:123-127)."""
    from eoe_tpu_torch.training import TRAINER
    return TRAINER[objective](model=model, train_specs=train_specs, test_specs=test_specs,
                              dataset="cifar10", oe_dataset="cifar100", datapath=datapath,
                              logger=logger, epochs=epochs, lr=1e-4, wdk=1e-3, milestones=[],
                              batch_size=BATCH, compute_dtype=dtype)


def _train_pinned(card, label, trace, trainer, data, n, n_test, serve, stats: bool) -> dict:
    """``train_cls``, ``eval_cls`` and a snapshot on a pinned set, counted
    and traced as path ``trace``;
    the snapshot served through ``AnomalyScorer`` by ``serve(path)`` and held
    against ``eval_cls``'s scores. Returns the launch counts: no attention
    kernel; the augmentation kernels once per train-pipeline call (the
    stacks' random crop), the stats kernel too where ``stats``."""
    import numpy as np
    ds, x_test = data
    trainer.ds = ds
    steps = trainer.epochs * (n // BATCH)
    _zero_counts(trace)
    t0 = time.perf_counter()
    state, roc = trainer.train_cls(ds, 0, "airplane", 0, seed=SEED)
    t_train = time.perf_counter() - t0
    eroc, _ = trainer.eval_cls(state, ds, 0, "airplane", 0)
    path = trainer.snapshot("snapshot_cls0_it0", state, trainer.epochs, ds.ds_statistics)
    trainer.logger.drain()   # the snapshot is written in the background
    counts = _counts()
    check_counts(counts, augment_counts(2 * steps + PREVIEW_CALLS, stats),
                 f"{label} (no attention kernel on the conv path)")
    losses = trainer.step_losses
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"{label}: expected {steps} finite losses, got {losses}")
    eval_scores = np.array([v for _, v in sorted(
        (int(k), v) for k, v in _read_json(trainer.logger.dir, "eval_cls0_it0_anomaly_scores")
        .items())])
    check(eval_scores.shape == (n_test,) and np.isfinite(eval_scores).all(),
          f"{label}: eval_cls gave bad scores")
    served = serve(path).score(x_test)
    serve_err = float(np.abs(served - eval_scores).max())
    check(serve_err <= 1e-4, f"{label}: served snapshot differs from eval_cls by {serve_err}")
    rates = [round(r, 1) for r in trainer.epoch_rates]
    print(f"{label}: {steps} steps of {BATCH}+{BATCH} images in {t_train:.2f} s; img/s per "
          f"epoch {rates}; losses {[round(x, 5) for x in losses]}; train AUROC {roc.auc:.4f}, "
          f"synthetic eval AUROC {eroc.auc:.4f}; snapshot served through AnomalyScorer, max "
          f"score difference to eval_cls {serve_err:.3g} (tol 1e-4); launches {counts} [{card}]")
    return counts


def _by_name(card, label, objective, model, specs, logdir) -> dict:
    """``Trainer.run`` of one class and one epoch by name (cifar10 with
    cifar100 as OE, the synthetic data of ``EOE_TPU_FAKE_DATA=1``), counted:
    finite losses and a results.json."""
    import numpy as np
    import torch
    from eoe_tpu_torch.utils.logger import Logger
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    try:
        trainer = _conv_trainer(objective, model, specs, ["normalize"],
                                Logger(logdir, noname=True), torch.float32, 1, datapath=logdir)
        _zero_counts()
        t0 = time.perf_counter()
        _, res = trainer.run(run_classes=[0])
        seconds = time.perf_counter() - t0
        counts = _counts()
    finally:
        os.environ.pop("EOE_TPU_FAKE_DATA", None)
    check_counts(counts, augment_counts(0, False), f"{label} {objective} by name")
    losses = trainer.step_losses
    check(len(losses) > 0 and np.isfinite(losses).all(),
          f"{label} {objective} by name: losses {losses}")
    results = _read_json(logdir, "results")
    check(np.isfinite(results["eval_mean_auc"]), f"{label} {objective}: results.json {results}")
    print(f"{label} {objective} by name (cifar10 class 0, cifar100 OE, synthetic data): "
          f"{len(losses)} steps in {seconds:.2f} s, losses {[round(x, 5) for x in losses]}, "
          f"synthetic AUROC {res['mean_auc']:.4f}; results.json written [{card}]")
    return counts


def phase_conv_training(card: str) -> dict:
    """CNN32 in fp32 with HSC on the benchmark's CIFAR-10 stack, then every
    conv objective by name."""
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models import AE32, CNN32
    from eoe_tpu_torch.utils.logger import Logger

    data = _pinned(np.random.default_rng(SEED), 32, CONV_N, CONV_TEST, CIFAR_SPECS,
                   ["normalize"])
    with tempfile.TemporaryDirectory() as logdir:
        trainer = _conv_trainer("hsc", CNN32(), CIFAR_SPECS, ["normalize"],
                                Logger(logdir, noname=True), torch.float32, CONV_EPOCHS)
        counts = _train_pinned(card, "conv train hsc fp32 CNN32", "conv_training", trainer,
                               data, CONV_N, CONV_TEST, lambda path: AnomalyScorer(
                                   path, CNN32(), test_specs=["normalize"], batch_size=BATCH),
                               stats=False)
    for objective, model in (("hsc", CNN32()), ("bce", CNN32(clf=True)), ("dsvdd", CNN32()),
                             ("ae", AE32())):
        with tempfile.TemporaryDirectory() as logdir:
            by_name = _by_name(card, "conv train", objective, model, ["normalize"], logdir)
        counts = {k: counts[k] + by_name[k] for k in counts}
    torch.cuda.empty_cache()
    return counts


def _rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


def _stem_hold(card, n):
    """The fused stem in fp32 on (n, 224, 224, 3) images that require a
    gradient. Its forward is the plain stem's own code, so the forward is
    held against torch's composition instead (``F.batch_norm`` in train mode,
    ReLU, ``F.max_pool2d``; ``var_mean`` for the statistics): outputs and
    batch statistics to 1e-5 of their max. Its backward is held against the
    plain stem under autograd: dW, dgamma, dbeta and dx to 1e-4 of theirs."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.stem import EPS, fused_stem_train, plain_stem
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(n, 224, 224, 3, device="cuda", generator=g).permute(0, 3, 1, 2)
    w = torch.randn(64, 3, 7, 7, device="cuda", generator=g) * (2.0 / (64 * 49)) ** 0.5
    gamma = 1.0 + 0.1 * torch.randn(64, device="cuda", generator=g)
    beta = 0.1 * torch.randn(64, device="cuda", generator=g)
    cot = torch.randn(n, 64, 56, 56, device="cuda", generator=g)
    with torch.no_grad():
        xc = F.conv2d(x, w, stride=2, padding=3)
        var_ref, mu_ref = torch.var_mean(xc, dim=(0, 2, 3), unbiased=False)
        ref = F.max_pool2d(F.relu(F.batch_norm(xc, None, None, gamma, beta, True, 0.0, EPS)),
                           3, 2, 1)
        del xc
    grads = []
    for fn in (fused_stem_train, plain_stem):
        leaves = [t.clone().requires_grad_() for t in (w, gamma, beta, x)]
        out, mu, var = fn(*leaves)
        if fn is fused_stem_train:
            fwd = {"out": _rel_err(out.detach(), ref), "mu": _rel_err(mu, mu_ref),
                   "var": _rel_err(var, var_ref)}
        out.backward(cot)
        grads.append([t.grad for t in leaves])
        del out, leaves
    errs = {**fwd, **{k: _rel_err(a, b) for k, a, b in zip(("dW", "dgamma", "dbeta", "dx"),
                                                             *grads)}}
    for k, e in errs.items():
        tol = 1e-5 if k in fwd else 1e-4
        check(e <= tol, f"fused stem at n={n}: {k} differs by {e} of its max (tol {tol})")
    print(f"wrn stem fp32, ({n}, 224, 224, 3): forward vs torch's batch_norm composition "
          + ", ".join(f"{k} {fwd[k]:.3g}" for k in fwd) + " of max (tol 1e-5); backward vs "
          "the plain stem under autograd " + ", ".join(f"{k} {errs[k]:.3g}" for k in errs
                                                       if k not in fwd)
          + f" of max (tol 1e-4) [{card}]")
    del grads, ref
    torch.cuda.empty_cache()


def _wrn_step(ds, fused: bool) -> tuple:
    """One fp32 HSC step of a WideResNet from seed 0 on ``ds``'s first batch,
    with SGD at the trainer's rate (Adam would turn float noise in near-zero
    gradients into updates of the learning rate's size): (loss, gradients,
    parameters after)."""
    import torch
    from eoe_tpu_torch.models import WideResNet
    from eoe_tpu_torch.training import TrainState
    from eoe_tpu_torch.training.optim import make_optimizer
    os.environ["EOE_TPU_FUSED_STEM"] = "1" if fused else "0"
    try:
        tr = _conv_trainer("hsc", WideResNet(), WRN_TEST_SPECS, WRN_TEST_SPECS, None,
                           torch.float32, 1)
        tr.init_weights(SEED)
        model = tr.model.to(tr.device)
        check(model.train().uses_fused_stem() == fused, "the stem switch did not take")
        names, params = zip(*model.named_parameters())
        st = TrainState(model, make_optimizer("sgd", params, tr.lr, tr.wdk, [], 1))
        dev = tr.device
        xn = torch.from_numpy(ds.train_set.gather_all()[:BATCH]).to(dev)
        xo = torch.from_numpy(ds.oe.train_set.gather_all()[:BATCH]).to(dev)
        ln = torch.zeros(BATCH, dtype=torch.int64, device=dev)
        lo = torch.ones(BATCH, dtype=torch.int64, device=dev)
        loss, *_ = tr.train_step(st, ds, xn, ln, xo, lo, torch.ones(BATCH, device=dev), None)
        grads = {n: p.grad.clone() for n, p in zip(names, params)}
        return loss.item(), grads, [p.detach().clone() for p in params]
    finally:
        os.environ.pop("EOE_TPU_FUSED_STEM", None)
        torch.cuda.empty_cache()


def phase_wrn_training(card: str) -> dict:
    """WideResNet+CBAM in bf16 with HSC on the benchmark's ImageNet-30 stack;
    the fused stem held against the plain one, and one fp32 step with it
    against one with ``EOE_TPU_FUSED_STEM=0``."""
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models import WideResNet
    from eoe_tpu_torch.utils.logger import Logger

    data = _pinned(np.random.default_rng(SEED), 256, WRN_N, WRN_TEST, WRN_SPECS, WRN_TEST_SPECS)
    with tempfile.TemporaryDirectory() as logdir:
        trainer = _conv_trainer("hsc", WideResNet(), WRN_SPECS, WRN_TEST_SPECS,
                                Logger(logdir, noname=True), torch.bfloat16, WRN_EPOCHS)
        counts = _train_pinned(card, "wrn train hsc bf16 WideResNet+CBAM", "wrn_training",
                               trainer, data, WRN_N, WRN_TEST, lambda path: AnomalyScorer(
                                   path, WideResNet(dtype=torch.bfloat16),
                                   test_specs=WRN_TEST_SPECS, batch_size=BATCH,
                                   compute_dtype=torch.bfloat16), stats=True)
        del trainer
    torch.cuda.empty_cache()
    for n in (8, 2 * BATCH):
        _stem_hold(card, n)
    # the deterministic test pipeline on both halves: both steps see the same
    # inputs; cuDNN's deterministic algorithms, so that the layers above the
    # stem give both steps the same bits (its atomics would differ by ~1e-4
    # of a gradient's max)
    ds32 = _pinned(np.random.default_rng(SEED + 1), 256, BATCH, 8, WRN_TEST_SPECS,
                   WRN_TEST_SPECS)[0]
    torch.backends.cudnn.deterministic = True
    try:
        _zero_counts()
        run = _wrn_step(ds32, fused=True)
        control = _wrn_step(ds32, fused=False)
        check_counts(_counts(), augment_counts(0, False), "wrn fp32 steps")
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, gk, pk), (lp, gp, pp) = run, control
    errs = {n: _rel_err(gk[n], gp[n]) for n in gp}
    worst = max(errs, key=errs.get)
    g_err = errs[worst]
    l_err = abs(lk - lp) / abs(lp)
    p_err = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    check(g_err <= 1e-4, f"wrn fp32 fused stem: gradients differ by {g_err} of their max")
    check(l_err <= 1e-5, f"wrn fp32 fused stem: losses differ by {l_err} (relative)")
    check(p_err <= 1e-5, f"wrn fp32 fused stem: parameters differ by {p_err} after the step")
    print(f"wrn train hsc fp32 fused stem vs EOE_TPU_FUSED_STEM=0, 1 step of {BATCH}+{BATCH}: "
          f"loss {lk:.6f} vs {lp:.6f}, err {l_err:.3g} rel (tol 1e-5), gradient err "
          f"{g_err:.3g} of max ({worst}; conv1 {errs['conv1.weight']:.3g}, bn1 "
          f"{errs['bn1.weight']:.3g} / {errs['bn1.bias']:.3g}; tol 1e-4), parameter err "
          f"{p_err:.3g} (tol 1e-5) [{card}]")
    return counts


class _Eager:
    """Within: every trainer takes the per-step loop of eager steps (the
    control of phase resident; ``Trainer._per_step``)."""

    def __enter__(self):
        from eoe_tpu_torch.training import Trainer
        Trainer._per_step = True

    def __exit__(self, *exc):
        from eoe_tpu_torch.training import Trainer
        Trainer._per_step = False


class _Env:
    """Within: the environment variables of ``values`` set (None: unset)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase resident's ways: (label, the context that selects it). "graph" is the
# default chunk (graphs.chunk_steps: one step a graph), "graph_epoch" the
# whole epoch a graph (the JAX package's default)
def _resident_ways(steps: int) -> dict:
    from contextlib import nullcontext
    return {"eager": _Eager, "graph": nullcontext,
            "graph_epoch": lambda: _Env(EOE_TPU_CHUNK=steps)}


def _resident_timed(label: str, ways: dict, order: list, run, logdir: str,
                    profiled: bool = True) -> dict:
    """Each way of ``order`` (ways in turns) through ``run(way, tag)``, which
    sets the launch counts to 0 before it and leaves its own:
    {way: [(result, host seconds, busy seconds or None), ...]}; the first
    run of a way is run again under ``torch.profiler`` where ``profiled``
    (the card's activity alone, no trace written: the busy seconds), and
    the launches its trace shows held against its counts; the graph way's
    are path ``resident_<label>``'s traced launches."""
    import torch
    from eoe_tpu_torch.utils.profiling import clear_spans, device_seconds
    out = {}
    for way in order:
        with ways[way]():
            t0 = time.perf_counter()
            result = run(way, "timed")
            torch.cuda.synchronize()
            seconds, busy = time.perf_counter() - t0, None
            if profiled and way not in out:
                clear_spans()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    run(way, "profiled")
                    torch.cuda.synchronize()
                busy = device_seconds(prof)
                hold_traced(prof, _counts(), f"resident {label} {way} (profiled run)",
                            f"resident_{label}" if way == "graph" else None)
            out.setdefault(way, []).append((result, seconds, busy))
    return out


def _resident_report(card: str, label: str, out: dict, images: int, steps: int,
                     rates=None):
    """Per way and run: seconds of the run (set-up included), img/s and ms a
    step over them, the card's busy seconds in the way's profiled run and
    their ratio to the first run's seconds (two runs: the profiled one
    carries the profiler's cost); ``rates``: {way: img/s of each epoch of a
    run}, the steady state."""
    for way, runs in out.items():
        parts = []
        for _, seconds, busy in runs:
            parts.append(f"{seconds:.3f} s, {images / seconds:.1f} img/s, "
                         f"{1000 * seconds / steps:.2f} ms a step"
                         + ("" if busy is None else
                            f", busy {busy:.3f} s in a profiled run ({100 * busy / seconds:.1f}% "
                            f"of this run's seconds)"))
        epochs = f"; img/s per epoch {rates[way]}" if rates and way in rates else ""
        print(f"resident {label} {way}: " + " | ".join(parts) + epochs + f" [{card}]")


def _state_err(a: dict, b: dict) -> float:
    """The largest difference of two state dicts, each tensor's over
    max(1, its largest magnitude in ``b``)."""
    return max(((a[k].float() - v.float()).abs().max() / v.float().abs().max().clamp(min=1))
               .item() for k, v in b.items())


def _res_cnn32(card: str, tmp: str) -> dict:
    """(a) CNN32 fp32 HSC on phase 8's pinned CIFAR-10 stack, 2 epochs:
    captured graphs (the default chunk of one step, and the whole epoch a
    graph) against the eager loop, in turns, with SGD (``_SgdTrainers``):
    losses, parameters and batch-norm averages 1e-5 (of max(1, |max|)), the
    train AUROC 1e-5, 1 crop launch a pipeline call each way; then Adam (the
    runner makes it capturable) both ways, held by drift: float noise on a
    near-zero gradient turns into a +-lr update (``ADAM_DRIFT_TOL``)."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models import CNN32

    ds, _ = _pinned(np.random.default_rng(SEED), 32, CONV_N, CONV_TEST, CIFAR_SPECS,
                    ["normalize"])
    steps = CONV_EPOCHS * (CONV_N // BATCH)
    trainer = _conv_trainer("hsc", CNN32(), CIFAR_SPECS, ["normalize"], None, torch.float32,
                            CONV_EPOCHS)
    trainer.ds = ds
    counts = {}

    def run(way, tag):
        trainer.step_losses, trainer.epoch_rates = [], []
        _zero_counts()
        state, roc = trainer.train_cls(ds, 0, "airplane", 0, seed=SEED)
        torch.cuda.synchronize()
        counts[way] = _counts()
        params = {k: v.detach().float().cpu().clone() for k, v in state.model.state_dict().items()}
        return np.array(trainer.step_losses), params, roc.auc, list(trainer.epoch_rates)

    ways = _resident_ways(CONV_N // BATCH)
    with _SgdTrainers():
        out = _resident_timed("cnn32", ways, ["eager", "graph", "graph_epoch", "graph",
                                              "eager"], run, tmp)
    (losses, params, auc, _), _, _ = out["eager"][0]
    for way, runs in out.items():
        check_counts(counts[way], augment_counts(2 * steps, False), f"resident cnn32 {way}")
        for (g_losses, g_params, g_auc, rates), _, _ in runs:
            l_err = float(np.abs(g_losses - losses).max() / np.abs(losses).max())
            p_err = _state_err(g_params, params)
            check(l_err <= 1e-5 and p_err <= 1e-5 and abs(g_auc - auc) <= 1e-5,
                  f"resident cnn32 {way}: losses {l_err:.3g} rel, parameters {p_err:.3g}, "
                  f"AUROC {g_auc} vs {auc} from the eager run (tol 1e-5)")
        print(f"resident cnn32 SGD {way}: losses {l_err:.3g} rel, parameters {p_err:.3g} from "
              f"the eager run (tol 1e-5); img/s per epoch {[round(r, 1) for r in rates]}")
    _resident_report(card, f"cnn32 fp32 SGD {CONV_N}+{CONV_N} x {CONV_EPOCHS} epochs", out,
                     steps * 2 * BATCH, steps)
    trainer.init_weights(SEED)
    init = {k: v.detach().float().cpu().clone() for k, v in trainer.model.state_dict().items()}
    adam = _resident_timed("cnn32_adam", ways, ["eager", "graph"], run, tmp, profiled=False)
    (a_losses, a_params, _, _), _, _ = adam["eager"][0]
    (g_losses, g_params, _, _), _, _ = adam["graph"][0]
    names = [k for k, _ in trainer.model.named_parameters()]   # as _member_drift
    drift = float(sum(((g_params[k] - a_params[k]).double() ** 2).sum() for k in names)
                  / sum(((a_params[k] - init[k]).double() ** 2).sum() for k in names)) ** 0.5
    l_err = float(np.abs(g_losses - a_losses).max() / np.abs(a_losses).max())
    check(drift <= ADAM_DRIFT_TOL, f"resident cnn32 Adam: graph parameters drift {drift:.3g} "
          f"of their change from the eager run's (tol {ADAM_DRIFT_TOL:.3g})")
    print(f"resident cnn32 Adam: parameters {_state_err(g_params, a_params):.3g} apart, drift "
          f"{drift:.3g} of their change (tol {ADAM_DRIFT_TOL:.3g}), losses {l_err:.3g} rel "
          f"from the eager run")
    _resident_report(card, f"cnn32 fp32 Adam {CONV_N}+{CONV_N} x {CONV_EPOCHS} epochs", adam,
                     steps * 2 * BATCH, steps)
    return counts["graph"]


def _res_clip(card: str, tmp: str) -> dict:
    """(b) ViT-B/32 bf16 HSC on phase 5's data and stack, one epoch of 4
    steps of 128 + 128: graphs against the eager loop, each loss within
    2^-8, 12 forward + 12 backward fused launches and 2 + 2 augmentation
    launches a step both ways."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32

    ds, _ = _combined(np.random.default_rng(SEED), ACCEPTANCE_SPECS)
    epochs = 1
    steps = epochs * (TRAIN_N // BATCH)
    trainer = _trainer(CLIP(VIT_B32, dtype=torch.bfloat16), ACCEPTANCE_SPECS, None,
                       torch.bfloat16, epochs)
    trainer.ds = ds
    counts = {}

    rates = {}

    def run(way, tag):
        trainer.step_losses, trainer.epoch_rates = [], []
        _zero_counts()
        trainer.train_cls(ds, 0, "airplane", 0, seed=SEED)
        torch.cuda.synchronize()
        counts[way] = _counts()   # the last run's: the pipelines' first-call probes left out
        if tag == "timed":   # the profiled run's rates carry the profiler's cost
            rates[way] = [round(r, 1) for r in trainer.epoch_rates]
        return np.array(trainer.step_losses)

    from eoe_tpu_torch.training import graphs
    layers, made, real = VIT_B32.vision_layers, [], graphs.ResidentSteps

    class Recorded(real):   # the graph's runners, for their capture seconds
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    graphs.ResidentSteps = Recorded
    try:
        out = _resident_timed("clip", _resident_ways(TRAIN_N // BATCH), ["eager", "graph"],
                              run, tmp)
    finally:
        graphs.ResidentSteps = real
    losses = out["eager"][0][0]
    for way in out:
        check_counts(counts[way], {"fwd": layers * steps, "bwd": layers * steps,
                                   **augment_counts(2 * steps, True)}, f"resident clip {way}")
    l_err = float(np.abs(out["graph"][0][0] - losses).max())
    check(np.isfinite(losses).all() and l_err <= 2 ** -8,
          f"resident clip: graph losses {l_err:.3g} from the eager run's (tol 2^-8)")
    print(f"resident clip bf16 ViT-B/32: losses {l_err:.3g} from the eager run (tol 2^-8); "
          f"{layers} + {layers} fused launches a step both ways; a capture's host seconds "
          f"(making room, recording, instantiating) "
          f"{[[round(x, 3) for x in r.capture_seconds] for r in made]}")
    _resident_report(card, f"clip bf16 ViT-B/32 128+128 x {steps} steps", out,
                     steps * 2 * BATCH, steps, rates)
    del trainer
    torch.cuda.empty_cache()
    return counts["graph"]


def _res_vmapped(card: str, tmp: str) -> dict:
    """(c) 4 vmapped CNN32 seeds on phase 8's pinned stack with SGD
    (``_SgdTrainers``), 2 epochs: each member's every loss, train AUROC and
    parameters from the graphs within 1e-5 of the eager program's."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import trainer as T
    from eoe_tpu_torch.training import vmapped_seeds as V

    ds, _ = _pinned(np.random.default_rng(SEED), 32, VM_PINNED_N, CONV_TEST, CIFAR_SPECS,
                    ["normalize"])
    trainer = _conv_trainer("hsc", CNN32(), CIFAR_SPECS, ["normalize"], None, torch.float32,
                            CONV_EPOCHS)
    trainer.ds = ds
    seeds = [T._seed(SEED, 0, it, 0) for it in range(4)]
    steps = CONV_EPOCHS * (VM_PINNED_N // BATCH)
    counts = {}

    rates = {}

    def run(way, tag):
        trainer.step_losses, trainer.epoch_rates = [], []
        _zero_counts()
        stack, rocs = V.train_cls_vmapped_seeds(trainer, ds, 0, "airplane", 4, seeds)
        torch.cuda.synchronize()
        counts[way] = _counts()   # the last run's: the pipelines' first-call probes left out
        if tag == "timed":   # the profiled run's rates carry the profiler's cost
            rates[way] = [round(r, 1) for r in trainer.epoch_rates]
        return (np.array(trainer.step_losses), [r.auc for r in rocs],
                [m[0] for m in stack.host_members()])

    with _SgdTrainers():
        out = _resident_timed("vmapped", _resident_ways(VM_PINNED_N // BATCH),
                              ["eager", "graph"], run, tmp)
    (losses, aucs, members), _, _ = out["eager"][0]
    (g_losses, g_aucs, g_members), _, _ = out["graph"][0]
    for way in out:
        check_counts(counts[way], augment_counts(2 * steps, False), f"resident vmapped {way}")
    l_err = float(np.abs(g_losses - losses).max() / np.abs(losses).max())
    p_err = max(_state_err(g, m) for m, g in zip(members, g_members))
    a_err = float(np.abs(np.subtract(g_aucs, aucs)).max())
    check(l_err <= 1e-5 and p_err <= 1e-5 and a_err <= 1e-5,
          f"resident vmapped: members' losses {l_err:.3g} rel, parameters {p_err:.3g}, "
          f"AUROCs {a_err:.3g} from the eager program (tol 1e-5)")
    print(f"resident vmapped 4 CNN32 seeds: losses {l_err:.3g} rel, parameters {p_err:.3g}, "
          f"AUROCs {a_err:.3g} from the eager program (tol 1e-5)")
    _resident_report(card, f"vmapped 4 CNN32 seeds SGD {VM_PINNED_N}+{VM_PINNED_N} x 2 epochs",
                     out, 4 * steps * 2 * BATCH, steps, rates)
    return counts["graph"]


def _res_evolve(card: str, tmp: str) -> dict:
    """(d) one generation of ``evolve_oe_cifar --ev-vmap`` at phase evolve's
    settings with SGD (``_SgdTrainers``): graphs against the eager loop,
    the same population and each fitness within 1e-4."""
    import numpy as np
    import torch
    from eoe_tpu_torch.main import evolve_oe_cifar

    argv = EV_CIFAR[:2] + ["--ev-generations", "1"] + EV_CIFAR[4:] + [
        "--classes", "0", "--datapath", tmp, "--ev-vmap"]
    counts = {}

    def run(way, tag):
        _zero_counts()
        with _SgdTrainers():
            history, _ = evolve_oe_cifar.main(argv + ["--superdir", f"{tmp}/ev_{way}_{tag}"])
        torch.cuda.synchronize()
        counts[way] = _counts()
        return history

    out = _resident_timed("evolve", {"eager": _Eager, "graph": _resident_ways(1)["graph"]},
                          ["eager", "graph"], run, tmp)
    he, hg = out["eager"][0][0], out["graph"][0][0]
    for way in out:
        check_counts(counts[way], {}, f"resident evolve {way} (no attention kernel)")
    check(he["pop"] == hg["pop"], f"resident evolve: populations {hg['pop']} vs {he['pop']}")
    f_err = float(np.abs(np.asarray(hg["fit"], float) - np.asarray(he["fit"], float)).max())
    check(f_err <= 1e-4, f"resident evolve: fitnesses {f_err:.3g} apart (tol 1e-4)")
    n = int(EV_CIFAR[1])
    print(f"resident evolve_oe_cifar --ev-vmap, one generation of {n}: populations equal, "
          f"fitness max difference {f_err:.3g} (tol 1e-4)")
    for way, runs in out.items():
        _, seconds, busy = runs[0]
        print(f"resident evolve --ev-vmap one generation {way}: {seconds:.3f} s, "
              f"{seconds / n:.4f} s an individual, busy {busy:.3f} s in a profiled run "
              f"({100 * busy / seconds:.1f}% of this run's seconds) [{card}]")
    return counts["graph"]


def _res_io(card: str, tmp: str) -> dict:
    """(e) ``train_cifar`` (2 seeds vmapped, 2 epochs) with the background
    writer and with ``EOE_TPU_SYNC_IO=1``: the same files and the same
    snapshot tensors (within 1e-6), and the seconds of each."""
    import glob

    import torch
    from eoe_tpu_torch.main import train_cifar

    one = ["-e", "2", "-it", "2", "--classes", "0", "--datapath", tmp]
    _zero_counts("resident_io")   # the traced run: the synthetic data, written once
    train_cifar.main(["-e", "1", "-it", "1", "--classes", "0", "--datapath", tmp,
                      "--superdir", "warm"])
    _counts()
    runs, seconds, counts = {}, {}, None
    for mode, sync in (("background", None), ("inline", 1), ("inline", 1),
                       ("background", None)):
        with _Env(EOE_TPU_SYNC_IO=sync):
            _zero_counts()
            t0 = time.perf_counter()
            train_cifar.main(one + ["--superdir", f"io_{mode}_{len(seconds.get(mode, []))}"])
            seconds.setdefault(mode, []).append(time.perf_counter() - t0)
            counts = _counts()
        runs.setdefault(mode, []).append(glob.glob(os.path.join(
            tmp, "results", f"io_{mode}_{len(seconds[mode]) - 1}",
            "log_*_hsc_cifar10_one_vs_rest"))[0])
    check_counts(counts, {}, "resident io (no attention kernel)")

    def listing(run):
        return sorted(os.path.relpath(f, run) if "/tb/" not in f else "tb/*"
                      for f in glob.glob(os.path.join(run, "**", "*"), recursive=True))

    files = {m: listing(r[0]) for m, r in runs.items()}
    check(files["background"] == files["inline"], f"resident io: the background writer's files "
          f"{sorted(set(files['background']) ^ set(files['inline']))} differ")
    err = 0.0
    for snap in glob.glob(os.path.join(runs["inline"][0], "snapshots", "*.pt")):
        a = torch.load(snap, weights_only=True)["params"]
        b = torch.load(os.path.join(runs["background"][0], "snapshots",
                                    os.path.basename(snap)), weights_only=True)["params"]
        err = max([err] + [(a[k].float() - b[k].float()).abs().max().item() for k in a])
    check(err <= 1e-6, f"resident io: snapshot tensors {err:.3g} apart (tol 1e-6)")
    print(f"resident io train_cifar ({' '.join(one[:4])}): {len(files['inline'])} files alike, "
          f"snapshot tensors {err:.3g} apart (tol 1e-6); seconds background "
          f"{[round(x, 3) for x in seconds['background']]}, EOE_TPU_SYNC_IO=1 "
          f"{[round(x, 3) for x in seconds['inline']]} [{card}]")
    return counts


def phase_resident(card: str) -> dict:
    """The resident epoch as captured CUDA graphs against the eager loop
    (see the module docstring); cuDNN deterministic, so that both ways sum
    alike."""
    import tempfile

    import torch
    saved = os.environ.get("EOE_TPU_FAKE_DATA")
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    torch.backends.cudnn.deterministic = True
    paths = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, fn in (("cnn32", _res_cnn32), ("clip", _res_clip),
                             ("vmapped", _res_vmapped), ("evolve", _res_evolve),
                             ("io", _res_io)):
                t0 = time.perf_counter()
                paths[f"resident_{name}"] = fn(card, tmp)
                print(f"resident {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = False
        if saved is None:
            os.environ.pop("EOE_TPU_FAKE_DATA", None)
        else:
            os.environ["EOE_TPU_FAKE_DATA"] = saved
    torch.cuda.empty_cache()
    return paths


# (filter, argument) pairs held on the card against the CPU: every MSM
# filter at the default CIFAR sweep's magnitudes (16 and 32 are NaN in both
# packages: every frequency zeroed, then 0/0), GCN, min-max and grayscale
FILTER_CASES = ([("gaussian_blur", dict(sigma=s)) for s in (1.0, 4.0, 16.0)]
                + [("unsharp_mask", dict(percent=p)) for p in (100.0, 800.0)]
                + [(f, dict(magnitude=m)) for f in ("high_pass_filter", "low_pass_filter")
                   for m in (1, 8, 15, 16, 32)]
                + [("global_contrast_normalization", dict(scale=s)) for s in ("l1", "l2")]
                + [("minmax_norm", {}), ("grayscale", {})])


def phase_filters(card: str):
    """Each filter of ``ops.filters`` on the card (cuDNN convolutions, cuFFT)
    against the same call on the CPU (pocketfft), on 256 CIFAR-sized images:
    to 1e-5 of max(1, the CPU result's largest magnitude), NaN exactly where
    the CPU result is NaN."""
    import numpy as np
    import torch
    from eoe_tpu_torch.ops import filters
    cpu = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 1, (256, 32, 32, 3))
                           .astype(np.float32))
    gpu = cpu.cuda()
    report = []
    for name, kw in FILTER_CASES:
        fn = getattr(filters, name)
        want, got = fn(cpu, **kw), fn(gpu, **kw).cpu()
        nan = torch.isnan(want)
        check(torch.equal(nan, torch.isnan(got)), f"filter {name}{kw}: NaN where the CPU's is not")
        scale = max(1.0, want[~nan].abs().max().item()) if (~nan).any() else 1.0
        err = (got[~nan] - want[~nan]).abs().max().item() if (~nan).any() else 0.0
        check(err <= 1e-5 * scale, f"filter {name}{kw}: {err} off the CPU (tol {1e-5 * scale})")
        report.append(f"{name}{list(kw.values()) or ''} {'NaN' if nan.all() else f'{err:.3g}'}")
    print(f"filters on the card against the CPU (tol 1e-5 of max(1, |max|)): "
          f"{'; '.join(report)} [{card}]")


def _epoch_rates(run: str) -> list:
    """img/s per epoch, as the trainer printed them into the run's print.txt."""
    import re
    with open(os.path.join(run, "print.txt")) as f:
        return [float(r) for r in re.findall(r"epoch \d+/\d+: .*, (\d+) img/s", f.read())]


def _run_dirs(root: str, pattern: str) -> list:
    import glob
    return sorted(glob.glob(os.path.join(root, "results", "**", pattern), recursive=True))


def _cli_clip(card: str, tmp: str) -> dict:
    """``train_clip_cifar`` through its ``main``, at full ViT-B/32 width from
    an OpenAI-format fp16 checkpoint made from seed 0, counted; its scores
    served back through ``AnomalyScorer`` from the run's snapshot."""
    import numpy as np
    import torch
    from eoe_tpu_torch.datasets import load_dataset
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.main import train_clip_cifar
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32, to_openai
    from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "ViT-B-32.pt")
    weights = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
    torch.save(to_openai(weights, VIT_B32), ckpt)
    del weights
    print(f"cli: OpenAI-format fp16 ViT-B/32 checkpoint from seed {SEED}, "
          f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB, in {time.perf_counter() - t0:.1f} s")
    os.environ["EOE_TPU_CLIP_CHECKPOINT"] = ckpt
    epochs = 2
    normal = load_dataset("cifar10", os.path.join(tmp, "datasets"), [0], 0, [], [])
    steps = epochs * -(-len(normal.train_set) // BATCH)
    n_test = len(normal.test_set)
    eval_batches = -(-n_test // BATCH)
    layers, text_layers = VIT_B32.vision_layers, VIT_B32.transformer_layers

    # ---- the main path, counted
    _zero_counts("cli_clip")
    t0 = time.perf_counter()
    _, res = train_clip_cifar.main(["--epochs", str(epochs), "--classes", "0", "-it", "1",
                                    "--datapath", tmp])
    seconds = time.perf_counter() - t0
    counts = _counts()
    # ---- end of the counted run
    check_counts(counts, {"fwd": text_layers + layers * (steps + eval_batches),
                          "bwd": layers * steps},
                 f"cli train_clip_cifar ({text_layers} prompt launches, {steps} steps, "
                 f"{eval_batches} eval batch)")
    run = _run_dirs(tmp, "log_*_clip_cifar10_one_vs_rest_E2")[0]
    results = _read_json(run, "results")
    check(np.isfinite(results["eval_mean_auc"]), f"cli train_clip_cifar: results {results}")
    setup = _read_json(run, "setup")
    check(setup["compute_dtype"] == "bfloat16" and setup["oe_dataset"] == "tinyimages",
          f"cli train_clip_cifar: setup {setup}")
    eval_scores = np.array([v for _, v in sorted(
        (int(k), v) for k, v in _read_json(run, "eval_cls0_it0_anomaly_scores").items())])

    model = CLIP(VIT_B32, dtype=torch.bfloat16)
    snapshot = torch.load(os.path.join(run, "snapshots", "snapshot_cls0_it0.pt"),
                          map_location="cpu", weights_only=True)
    model.load_state_dict(snapshot["params"])
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH, center=center,
                           compute_dtype=torch.bfloat16,
                           test_specs=[{"op": "clip_pil_preprocessing",
                                        "resolution": VIT_B32.image_resolution},
                                       {"op": "clip_tensor_preprocessing"}])
    served = scorer.score(normal.test_set.gather_all())
    serve_err = float(np.abs(served - eval_scores).max())
    check(eval_scores.shape == (n_test,) and serve_err <= 1e-4,
          f"cli train_clip_cifar: AnomalyScorer differs from the run's scores by {serve_err}")
    print(f"cli train_clip_cifar (ViT-B/32 bf16, cifar10 class 0, tinyimages OE, synthetic "
          f"data): {steps} steps in {seconds:.2f} s with the checkpoint load, img/s per epoch "
          f"{_epoch_rates(run)}; synthetic AUROC {results['eval_mean_auc']:.4f}; snapshot "
          f"served through AnomalyScorer, max score difference {serve_err:.3g} (tol 1e-4); "
          f"launches {counts} [{card}]")
    del model, scorer, snapshot
    torch.cuda.empty_cache()
    return counts


def _cli_conv(card: str, tmp: str) -> dict:
    """``train_cifar``, ``train_fmnist`` and two ``multiscale_cifar`` sweeps
    through their ``main``, counted (no attention kernel lies on them); the
    test-only sweep must evaluate its magnitude-0 snapshot at
    magnitude 8 without training."""
    import glob

    import numpy as np
    from eoe_tpu_torch.main import multiscale_cifar, train_cifar, train_fmnist

    one = ["--classes", "0", "--datapath", tmp]
    runs = [("train_cifar", train_cifar.main, ["-e", "2", "-it", "2"] + one,
             "log_*_hsc_cifar10_one_vs_rest"),
            ("train_fmnist", train_fmnist.main, ["-e", "2", "-it", "1"] + one,
             "log_*_hsc_fmnist_one_vs_rest"),
            ("multiscale_cifar lpf+train_nominal", multiscale_cifar.main,
             ["--ms-mode", "lpf+train_nominal", "--magnitudes", "0", "8", "-e", "1", "-it", "1"]
             + one, "log_*_MULTISCALE_hsc_lpf+train_nominal_OEinf"),
            ("multiscale_cifar hpf+test_anomalous", multiscale_cifar.main,
             ["--ms-mode", "hpf+test_anomalous", "--magnitudes", "0", "8", "-e", "1", "-it", "1"]
             + one, "log_*_MULTISCALE_hsc_hpf+test_anomalous_OEinf")]
    # ---- the main path, counted
    _zero_counts("cli_conv")
    out = []
    for label, main, argv, _ in runs:
        t0 = time.perf_counter()
        out.append((main(argv), time.perf_counter() - t0))
    counts = _counts()
    # ---- end of the counted run
    check_counts(counts, {}, "cli conv runners (no attention kernel)")
    for (label, _, argv, pattern), (result, seconds) in zip(runs, out):
        run = _run_dirs(tmp, pattern)[0]
        if label.startswith("multiscale"):
            aucs = [a for a, _ in result]
            check(len(aucs) == 2 and np.isfinite(aucs).all(), f"cli {label}: AUROCs {result}")
            trained = []
            magnitude_runs = [glob.glob(os.path.join(run, f"log_*_magnitude_{m}"))[0]
                              for m in (0, 8)]
            for r in magnitude_runs:
                with open(os.path.join(r, "print.txt")) as f:
                    printed = f.read()
                trained.append(("epoch 1/1" in printed, "Loaded snapshot" in printed))
            reuse = "test_anomalous" in label
            check(trained == [(True, False), (not reuse, reuse)],
                  f"cli {label}: (trained, loaded) per magnitude {trained}")
            rates = [_epoch_rates(r) for r in magnitude_runs]
            what = (f"AUROC at magnitudes 0, 8: {[round(a, 4) for a in aucs]}; img/s per "
                    f"epoch {rates}" + ("; magnitude 8 evaluated the magnitude-0 snapshot "
                                        "with epochs=0" if reuse else ""))
        else:
            check(np.isfinite(result[1]["mean_auc"]), f"cli {label}: {result[1]}")
            what = (f"synthetic AUROC {result[1]['mean_auc']:.4f}; img/s per epoch "
                    f"{_epoch_rates(run)}")
        print(f"cli {label} ({' '.join(argv[:-4])}): {seconds:.2f} s; {what} [{card}]")
    return counts


def phase_cli(card: str) -> tuple:
    """The port's runners through ``main(argv)`` on the card, on the synthetic
    data of ``EOE_TPU_FAKE_DATA=1`` with Tiny Images as the CIFAR-10 OE set."""
    import tempfile
    saved = {k: os.environ.get(k) for k in ("EOE_TPU_FAKE_DATA", "EOE_TPU_CLIP_CHECKPOINT")}
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = _cli_clip(card, tmp)
            conv = _cli_conv(card, tmp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return clip, conv


# the folder phase's synthetic data, in the JAX package's on-disk layouts
FOLDER_HW = 256
IN30_TRAIN0, IN30_TRAIN_OTHER, IN30_VAL = 256, 8, 10   # images a class
IN21K_WNIDS, IN21K_PER_WNID = 16, 32
IN21K_1K = ("n12267677", "n02690373")                  # ImageNet-1k synsets: left out
MVTEC_TRAIN, MVTEC_TEST = 64, 16                        # good train; good and broken test
CUSTOM_CLASSES, CUSTOM_TRAIN, CUSTOM_TEST, CUSTOM_BATCH = ("nut", "screw"), 48, 12, 16


def _write_blob(folder: str, classes: list, per_class: list, rng):
    """A class-folder tree's blob (``_eoe_blob_256x256.npy``) and its .json
    sidecar, as ``datasets.folder.build_blob`` writes them, from seeded
    random images (the paths name files that are never read)."""
    import numpy as np
    os.makedirs(folder, exist_ok=True)
    n = sum(per_class)
    arr = np.lib.format.open_memmap(
        os.path.join(folder, f"_eoe_blob_{FOLDER_HW}x{FOLDER_HW}.npy"), mode="w+",
        dtype=np.uint8, shape=(n, FOLDER_HW, FOLDER_HW, 3))
    for i in range(0, n, 128):
        arr[i:i + 128] = rng.integers(0, 256, arr[i:i + 128].shape, dtype=np.uint8)
    arr.flush()
    del arr
    targets = [c for c, k in enumerate(per_class) for _ in range(k)]
    paths = [f"{classes[c]}/{i:05d}.JPEG" for c, k in enumerate(per_class) for i in range(k)]
    with open(os.path.join(folder, f"_eoe_blob_{FOLDER_HW}x{FOLDER_HW}.npy.json"), "w") as f:
        json.dump({"classes": classes, "targets": targets, "paths": paths}, f)
    return n


def _png(img) -> bytes:
    """An RGB uint8 image as PNG bytes, written with zlib alone."""
    import struct
    import zlib
    h, w, _ = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    raw = b"".join(b"\x00" + row.tobytes() for row in img)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _folder_data(ds: str) -> dict:
    """ImageNet-30 train and val and ImageNet-21k as 256x256 blobs, one
    MVTec-AD class as its .npz blob, and a custom tree of 64x64 PNG files in
    the general layout; returns the sizes."""
    import numpy as np
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    from eoe_tpu_torch.datasets.mvtec import ENLARGE
    rng = np.random.default_rng(SEED)
    n_train = _write_blob(os.path.join(ds, "imagenet_ad", "train"), AD_CLASSES,
                          [IN30_TRAIN0] + [IN30_TRAIN_OTHER] * 29, rng)
    n_val = _write_blob(os.path.join(ds, "imagenet_ad", "val"), AD_CLASSES,
                        [IN30_VAL] * 30, rng)
    wnids = sorted(list(IN21K_1K) + [f"n{9000000 + i:08d}" for i in range(IN21K_WNIDS - 2)])
    n_21k = _write_blob(os.path.join(ds, "imagenet22k", "fall11_whole_extracted"), wnids,
                        [IN21K_PER_WNID] * IN21K_WNIDS, rng)
    mv = os.path.join(ds, "mvtec")
    os.makedirs(mv)
    shape = (FOLDER_HW, FOLDER_HW, 3)
    np.savez(os.path.join(mv, f"admvtec_{FOLDER_HW}x{FOLDER_HW}.npz"),
             train_data=rng.integers(0, 256, (MVTEC_TRAIN, *shape), dtype=np.uint8),
             train_labels=np.zeros(MVTEC_TRAIN, np.int64),
             test_data=rng.integers(0, 256, (2 * MVTEC_TEST, *shape), dtype=np.uint8),
             test_labels=np.zeros(2 * MVTEC_TEST, np.int64),
             test_anomaly_labels=np.repeat(np.arange(2), MVTEC_TEST),
             anomaly_label_strings=np.asarray(["good", "bottle_broken"]))
    for split, folders in (("train", (("normal", CUSTOM_TRAIN),)),
                           ("test", (("anomalous", CUSTOM_TEST), ("normal", CUSTOM_TEST)))):
        for cls in CUSTOM_CLASSES:
            for sub, k in folders:
                folder = os.path.join(ds, "custom", split, cls, sub)
                os.makedirs(folder)
                for i in range(k):
                    with open(os.path.join(folder, f"{i:03d}.png"), "wb") as f:
                        f.write(_png(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)))
    mib = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ds) for f in fs)
    return {"imagenet30_train": n_train, "imagenet30_val": n_val, "imagenet21k": n_21k,
            "mvtec_train": MVTEC_TRAIN * ENLARGE, "mvtec_test": 2 * MVTEC_TEST,
            "custom_files": len(CUSTOM_CLASSES) * (CUSTOM_TRAIN + 2 * CUSTOM_TEST),
            "MiB": round(mib / 2 ** 20, 1)}


def _folder_clip(card: str, tmp: str) -> dict:
    """``train_clip_imagenet`` through its ``main`` with its JAX defaults
    (bf16, 128 + 128, ImageNet-21k as OE) at full ViT-B/32 width from an
    OpenAI-format fp16 checkpoint made from seed 0, class 0, one seed, 2
    epochs, counted; its scores served back through ``AnomalyScorer``."""
    import numpy as np
    import torch
    from eoe_tpu_torch.datasets import load_dataset
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.main import train_clip_imagenet
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32, to_openai
    from eoe_tpu_torch.training.clip import prompt_center

    ckpt = os.path.join(tmp, "ViT-B-32.pt")
    weights = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
    torch.save(to_openai(weights, VIT_B32), ckpt)
    del weights
    os.environ["EOE_TPU_CLIP_CHECKPOINT"] = ckpt
    epochs = 2
    steps = epochs * -(-IN30_TRAIN0 // BATCH)
    n_test = 30 * IN30_VAL
    eval_batches = -(-n_test // BATCH)
    layers, text_layers = VIT_B32.vision_layers, VIT_B32.transformer_layers
    expected = {"fwd": text_layers + layers * (steps + eval_batches), "bwd": layers * steps}

    # ---- the main path, counted
    _zero_counts("folder_clip")
    t0 = time.perf_counter()
    _, res = train_clip_imagenet.main(["--epochs", str(epochs), "--classes", "0", "-it", "1",
                                       "--datapath", tmp])
    seconds = time.perf_counter() - t0
    counts = _counts()
    # ---- end of the counted run
    check_counts(counts, expected,
                 f"folder train_clip_imagenet ({text_layers} prompt launches, {steps} steps, "
                 f"{eval_batches} eval batches)")
    check(np.isfinite(res["mean_auc"]), f"folder train_clip_imagenet: results {res}")
    run = _run_dirs(tmp, "log_*_clip_imagenet_one_vs_rest_E2")[0]
    setup = _read_json(run, "setup")
    check(setup["compute_dtype"] == "bfloat16" and setup["oe_dataset"] == "imagenet21k",
          f"folder train_clip_imagenet: setup {setup}")
    eval_scores = np.array([v for _, v in sorted(
        (int(k), v) for k, v in _read_json(run, "eval_cls0_it0_anomaly_scores").items())])

    model = CLIP(VIT_B32, dtype=torch.bfloat16)
    snapshot = torch.load(os.path.join(run, "snapshots", "snapshot_cls0_it0.pt"),
                          map_location="cpu", weights_only=True)
    model.load_state_dict(snapshot["params"])
    center = prompt_center(model, AD_CLASSES[0], AD_CLASSES)
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH, center=center,
                           compute_dtype=torch.bfloat16,
                           test_specs=[{"op": "clip_pil_preprocessing",
                                        "resolution": VIT_B32.image_resolution},
                                       {"op": "clip_tensor_preprocessing"}])
    test_set = load_dataset("imagenet", os.path.join(tmp, "datasets"), [0], 0,
                            train_clip_imagenet.TRAIN_SPECS, []).test_set
    served = scorer.score(test_set.gather_all())
    serve_err = float(np.abs(served - eval_scores).max())
    check(eval_scores.shape == (n_test,) and serve_err <= 1e-4,
          f"folder train_clip_imagenet: AnomalyScorer differs from the run's scores by "
          f"{serve_err}")
    print(f"folder train_clip_imagenet (ViT-B/32 bf16, imagenet class 0 from 256x256 blobs, "
          f"imagenet21k OE blob, 1k synsets left out): {steps} steps in {seconds:.2f} s of main "
          f"with the checkpoint load, img/s per epoch {_epoch_rates(run)}; synthetic AUROC "
          f"{res['mean_auc']:.4f}; snapshot served through AnomalyScorer, max score "
          f"difference {serve_err:.3g} (tol 1e-4); launches {counts}, expected {expected} "
          f"[{card}]")
    del model, scorer, snapshot
    torch.cuda.empty_cache()
    return counts


def _folder_conv(card: str, tmp: str) -> dict:
    """``train_imagenet`` (WideResNet+CBAM) and ``train_mvtec`` (gcn-normalize)
    on the blobs, and ``train_custom`` on the PNG tree with the folder cache
    at 0, through their ``main``, counted (no attention kernel lies on
    them). The custom run must stream its normal half step by step and
    its test split batch by batch (``Subset.gather``), never whole."""
    import numpy as np
    from eoe_tpu_torch.datasets import bases
    from eoe_tpu_torch.datasets.folder import FolderSource
    from eoe_tpu_torch.main import train_custom, train_imagenet, train_mvtec

    one = ["-e", "1", "--classes", "0", "-it", "1", "--datapath", tmp]
    runs = [("train_imagenet", train_imagenet.main, one, "log_*_hsc_imagenet_one_vs_rest"),
            ("train_mvtec", train_mvtec.main, one, "log_*_hsc_mvtec_one_vs_rest"),
            ("train_custom", train_custom.main, ["-b", str(CUSTOM_BATCH)] + one,
             "log_*_hsc_custom_")]
    gathers = []
    saved = {name: getattr(bases.Subset, name) for name in ("gather", "gather_all")}

    def recorded(name):
        def gather(self, *args):
            gathers.append((name, type(self.source).__name__, len(self.source),
                            len(args[0]) if args else len(self)))
            return saved[name](self, *args)
        return gather

    cache = FolderSource.DEFAULT_CACHE_BYTES
    # ---- the main path, counted
    _zero_counts("folder_conv")
    out = []
    for label, main, argv, _ in runs:
        t0 = time.perf_counter()
        if label == "train_custom":
            FolderSource.DEFAULT_CACHE_BYTES = 0
            for name in saved:
                setattr(bases.Subset, name, recorded(name))
        try:
            out.append((main(argv), time.perf_counter() - t0))
        finally:
            FolderSource.DEFAULT_CACHE_BYTES = cache
            for name, fn in saved.items():
                setattr(bases.Subset, name, fn)
    counts = _counts()
    # ---- end of the counted run
    check_counts(counts, {}, "folder conv runners (no attention kernel)")
    n_train_src = len(CUSTOM_CLASSES) * CUSTOM_TRAIN
    n_test_src = len(CUSTOM_CLASSES) * 2 * CUSTOM_TEST
    steps = -(-CUSTOM_TRAIN // CUSTOM_BATCH)
    eval_batches = -(-2 * CUSTOM_TEST // CUSTOM_BATCH)
    folder = [g for g in gathers if g[1] == "FolderSource"]
    # the preview grids gather first: 40 normal train images, then each
    # binary class of the test split
    train_steps = [g for g in folder if g[:3] == ("gather", "FolderSource", n_train_src)]
    test_batches = [g for g in folder if g[2] == n_test_src]
    check([g[3] for g in train_steps] == [min(40, CUSTOM_TRAIN)] + [CUSTOM_BATCH] * steps
          and [(g[0], g[3]) for g in test_batches]
          == [("gather", CUSTOM_TEST)] * 2 + [("gather", CUSTOM_BATCH)] * eval_batches,
          f"folder train_custom did not stream ({steps} train steps and {eval_batches} eval "
          f"batches of {CUSTOM_BATCH} expected after the previews' gathers): host gathers "
          f"{folder}")
    train_steps, test_batches = train_steps[1:], test_batches[2:]
    for (label, _, argv, pattern), ((_, res), seconds) in zip(runs, out):
        check(np.isfinite(res["mean_auc"]), f"folder {label}: {res}")
        run = _run_dirs(tmp, pattern)[0]
        extra = ""
        if label == "train_custom":
            keys = list(_read_json(run, "eval_cls0_it0_anomaly_scores"))
            check(keys[0] == "nut/anomalous/000.png" and len(keys) == 2 * CUSTOM_TEST,
                  f"folder train_custom: score keys {keys[:3]}")
            extra = (f"; streamed: {len(train_steps)} host gathers of the normal half, "
                     f"{len(test_batches)} of the test split; scores keyed by file "
                     f"({keys[0]}, ...)")
        print(f"folder {label} ({' '.join(argv[:-2])}): {seconds:.2f} s of main; synthetic "
              f"AUROC {res['mean_auc']:.4f}; img/s per epoch {_epoch_rates(run)}{extra} "
              f"[{card}]")
    return counts


def phase_folder(card: str) -> tuple:
    """The folder-image data layer's runners through ``main(argv)`` on the
    card, on synthetic data written in the JAX package's layouts."""
    import tempfile
    saved = os.environ.get("EOE_TPU_CLIP_CHECKPOINT")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            sizes = _folder_data(os.path.join(tmp, "datasets"))
            print(f"folder data: {sizes} in {time.perf_counter() - t0:.1f} s")
            clip = _folder_clip(card, tmp)
            conv = _folder_conv(card, tmp)
    finally:
        if saved is None:
            os.environ.pop("EOE_TPU_CLIP_CHECKPOINT", None)
        else:
            os.environ["EOE_TPU_CLIP_CHECKPOINT"] = saved
    return clip, conv


# the evolve and custom phases' cuts of the runners' JAX defaults
EV_CIFAR = ["--ev-generation-pool", "8", "--ev-generations", "2", "--epochs", "2",
            "--ev-mutation-pool", "1000"]      # defaults: 64, 50, 30, 10000
EV_IMAGENET = ["--ev-generation-pool", "2", "--ev-generations", "1", "--epochs", "1"]
EV_RANDOM_SAMPLES = 4                          # default 2000
EV_ONEOFKBEST = 50                             # evolve_oe_cifar's default
CUSTOM_NORMAL, CUSTOM_ANOMALOUS = 48, 16       # seeded 64x64 PNGs of two colours


def _evaluated(run: str) -> int:
    """Individuals an evolution run trained, from its print.txt."""
    with open(os.path.join(run, "print.txt")) as f:
        return f.read().count("Evaluate ind")


def _distance_hold(card: str, oeds, pop: list) -> str:
    """The GA's mutation distances on the card against the CPU (1e-5
    relative) and its oneofkbest picks from the same draws: equal, or where
    not, tied within the measured error."""
    import numpy as np
    from eoe_tpu_torch import evolve as ev
    ind = [i for individual in pop for i in individual]
    cand = [int(i) for i in np.random.default_rng(SEED).integers(0, len(oeds), 1000)]
    d = {dev: ev._sq_dists(ev._gather_f32(oeds, ind, dev), ev._gather_f32(oeds, cand, dev))
         for dev in ("cuda", "cpu")}
    # a candidate that is the sample itself lies at 0 on both
    rel = float((np.abs(d["cuda"] - d["cpu"]) / np.maximum(np.abs(d["cpu"]), 1e-30)).max())
    check(d["cuda"].dtype == np.float32 and rel <= 1e-5,
          f"evolve: mutation distances on the card differ from the CPU's by {rel} (tol 1e-5)")
    err = float(np.abs(d["cuda"] - d["cpu"]).max())
    same = ties = 0
    for n in range(len(ind)):
        for draw in range(8):
            picks = []
            for dev in ("cuda", "cpu"):
                ev.seed_evolution((SEED, n, draw))
                picks.append(ev._nearest_excl_self(d[dev][n], EV_ONEOFKBEST))
            if cand[picks[0]] == cand[picks[1]]:
                same += 1
                continue
            gap = abs(float(d["cpu"][n][picks[0]]) - float(d["cpu"][n][picks[1]]))
            check(gap <= 2 * err, f"evolve: the card picked candidate {cand[picks[0]]}, the "
                  f"CPU {cand[picks[1]]}, {gap} apart (distance error {err})")
            ties += 1
    return (f"mutation distances of {len(ind)} individuals to 1000 candidates on the card vs "
            f"the CPU: max relative difference {rel:.3g} (tol 1e-5); oneofkbest={EV_ONEOFKBEST} "
            f"picks equal in {same} of {same + ties} draws, the rest tied within {err:.3g}")


def phase_evolve(card: str) -> dict:
    """The evolutionary OE search through its runners' ``main`` on the card:
    ``evolve_oe_cifar`` (CNN32, CIFAR-10 with Tiny Images as OE) with its
    JAX defaults cut in population, generations, epochs and mutation pool;
    a resume of a copy with its last generation dropped, which must redraw
    that generation exactly; ``random_oe_cifar``; ``evolve_oe_imagenet``
    (WideResNet+CBAM on ImageNet-30 blobs with ImageNet-21k as OE). Then the
    mutation distances on the card against the CPU. Counted: no kernel of
    the repository lies on this path."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    from eoe_tpu_torch.datasets import load_dataset
    from eoe_tpu_torch.main import evolve_oe_cifar, evolve_oe_imagenet, random_oe_cifar

    saved = os.environ.get("EOE_TPU_FAKE_DATA")
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _folder_data(os.path.join(tmp, "datasets"))
            one = ["--classes", "0", "--datapath", tmp]
            # ---- the main path, counted
            _zero_counts("evolve")
            t0 = time.perf_counter()
            h1, _ = evolve_oe_cifar.main(EV_CIFAR + one + ["--superdir", f"{tmp}/ev"])
            t_cifar = time.perf_counter() - t0
            run = glob.glob(os.path.join(tmp, "ev", "log_*_evolve_*"))[0]
            resumed = os.path.join(tmp, "resume")
            shutil.copytree(run, resumed)
            with open(os.path.join(resumed, "results.json")) as f:
                cut = json.load(f)
            for k in ("pop", "fit", "mean_fit", "std_fit", "max_fit", "min_fit"):
                cut[k] = cut[k][:-1]
            with open(os.path.join(resumed, "results.json"), "w") as f:
                json.dump(cut, f)
            t0 = time.perf_counter()
            h2, _ = evolve_oe_cifar.main(EV_CIFAR + one + ["--superdir", f"{tmp}/ev",
                                                           "--ev-continue-run", resumed])
            t_resume = time.perf_counter() - t0
            t0 = time.perf_counter()
            h3, _ = random_oe_cifar.main(["--ev-samples", str(EV_RANDOM_SAMPLES), "-e", "2"]
                                         + one + ["--superdir", f"{tmp}/rand"])
            t_random = time.perf_counter() - t0
            t0 = time.perf_counter()
            h4, _ = evolve_oe_imagenet.main(EV_IMAGENET + one + ["--superdir", f"{tmp}/in"])
            t_imagenet = time.perf_counter() - t0
            counts = _counts()
            # ---- end of the counted run
            check_counts(counts, {}, "evolve runners (no attention kernel)")
            # the WideResNet individuals' two seeds one after the other, as
            # before the vmapped seeds
            with _SequentialSeeds():
                t0 = time.perf_counter()
                h5, _ = evolve_oe_imagenet.main(EV_IMAGENET + one + ["--superdir", f"{tmp}/ins"])
                t_imagenet_seq = time.perf_counter() - t0
            check(len(h1["pop"]) == 2 and h2["pop"] == h1["pop"] and h2["fit"][0] == h1["fit"][0],
                  f"evolve: the resumed run's populations {h2['pop']} differ from the "
                  f"uninterrupted run's {h1['pop']}")
            for label, h, shape in (("evolve_oe_cifar", h1, (2, 8)), ("resume", h2, (2, 8)),
                                    ("random_oe_cifar", h3, (1, EV_RANDOM_SAMPLES)),
                                    ("evolve_oe_imagenet", h4, (1, 2))):
                fits = np.asarray(h["fit"], dtype=np.float64)
                check(fits.shape == shape and np.isfinite(fits).all()
                      and ((fits >= 0) & (fits <= 1)).all(), f"evolve {label}: fitness {fits}")
            runs = {label: glob.glob(os.path.join(tmp, sub, "log_*_evolve_*"))
                    for label, sub in (("cifar", "ev"), ("random", "rand"),
                                       ("imagenet", "in"))}
            check(os.path.isdir(resumed + "---CNTD"), f"evolve: no {resumed}---CNTD")
            n_cifar = _evaluated(run)
            n_resume = _evaluated(resumed + "---CNTD")
            n_random = _evaluated(runs["random"][0])
            n_imagenet = _evaluated(runs["imagenet"][0])
            run_seq = glob.glob(os.path.join(tmp, "ins", "log_*_evolve_*"))[0]
            n_imagenet_seq = _evaluated(run_seq)
            try:     # the genealogy and the overviews are drawn with matplotlib
                import matplotlib  # noqa: F401
                figures = ("genealogy.png", "overview_best.png", "overview_worst.png")
            except ImportError:
                figures = ()
            for r in (run, runs["imagenet"][0]):
                for name in ("results.json", "evolution.json", "individuals") + figures:
                    check(os.path.exists(os.path.join(r, name)), f"evolve: {r} lacks {name}")
            oeds = load_dataset("cifar10", os.path.join(tmp, "datasets"), [0], 0,
                                evolve_oe_cifar.TRAIN_SPECS, evolve_oe_cifar.TEST_SPECS,
                                oe_name="tinyimages").oe.train_set
            hold = _distance_hold(card, oeds, h1["pop"][-1][:4])
    finally:
        if saved is None:
            os.environ.pop("EOE_TPU_FAKE_DATA", None)
        else:
            os.environ["EOE_TPU_FAKE_DATA"] = saved
    for label, seconds, n, h in (("evolve_oe_cifar", t_cifar, n_cifar, h1),
                                 ("resume", t_resume, n_resume, h2),
                                 ("random_oe_cifar", t_random, n_random, h3),
                                 ("evolve_oe_imagenet", t_imagenet, n_imagenet, h4),
                                 ("evolve_oe_imagenet, sequential seeds", t_imagenet_seq,
                                  n_imagenet_seq, h5)):
        print(f"evolve {label}: {seconds:.2f} s of main, {n} individuals trained, "
              f"{seconds / max(n, 1):.3f} s per individual; fitness of the last generation "
              f"{[round(f, 4) for f in h['fit'][-1]]} [{card}]")
    print(f"evolve: resumed run redrew generation {len(h1['pop']) - 1} exactly: "
          f"{h2['pop'][-1]}; figures drawn: {list(figures) or 'none (no matplotlib)'}")
    print(f"evolve: {hold} [{card}]")
    return counts


def _custom_images(root: str):
    """A split-less custom tree: dark normal and bright anomalous 64x64 PNGs."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    for folder, n, level in (("normal", CUSTOM_NORMAL, 40), ("anomalous", CUSTOM_ANOMALOUS, 200)):
        os.makedirs(os.path.join(root, folder))
        for i in range(n):
            img = np.full((64, 64, 3), level, np.uint8) + rng.integers(0, 30, (64, 64, 3),
                                                                       dtype=np.uint8)
            with open(os.path.join(root, folder, f"{i:03d}.png"), "wb") as f:
                f.write(_png(img))


def phase_custom(card: str) -> dict:
    """The custom-model workflow through its runners' ``main`` on the card:
    ``train_only_custom`` trains ``WideResNetCustom`` (the WideResNet+CBAM
    feature model and a prediction head) with the feature model frozen,
    then once more from a feature-model-only snapshot of that run;
    ``inference_custom`` scores the second run's snapshot, held against
    ``AnomalyScorer`` on the same images. Counted: no kernel of the
    repository lies on this path."""
    import argparse
    import glob
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.datasets import DS_CHOICES, load_dataset
    from eoe_tpu_torch.datasets.custom import ADCustomDS
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.main import inference_custom, train_only_custom
    from eoe_tpu_torch.models.custom import WideResNetCustom
    from eoe_tpu_torch.training.trainer import Trainer

    saved_cls = {k: getattr(ADCustomDS, k) for k in ("train_only", "eval_only", "base_folder",
                                                     "classes")}
    saved_choice = dict(DS_CHOICES["custom"])
    loaded = []
    init_or_load = Trainer._init_or_load

    def recorded(self, *args, **kwargs):
        state, epoch = init_or_load(self, *args, **kwargs)
        loaded.append({k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()})
        return state, epoch

    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "data")
            _custom_images(data)
            common = ["--custom-dataset-path", data, "--custom-model-add-prediction-head"]
            train = common + ["-e", "2", "-it", "1", "--custom-model-freeze"]
            Trainer._init_or_load = recorded
            # ---- the main path, counted
            _zero_counts("custom")
            seconds = {}
            t0 = time.perf_counter()
            train_only_custom.main(train + ["--log-path", f"{tmp}/frozen"])
            seconds["train_only_custom"] = time.perf_counter() - t0
            snap1 = glob.glob(f"{tmp}/frozen/**/snapshot_cls0_it0.pt", recursive=True)[0]
            params1 = torch.load(snap1, map_location="cpu", weights_only=True)["params"]
            features = {k.split(".", 1)[1]: v for k, v in params1.items()
                        if k.startswith("feature_model.")}
            torch.save(features, os.path.join(tmp, "features.pt"))
            t0 = time.perf_counter()
            train_only_custom.main(train + ["--log-path", f"{tmp}/features",
                                            "--custom-model-snapshot",
                                            os.path.join(tmp, "features.pt")])
            seconds["train_only_custom from features"] = time.perf_counter() - t0
            snap2 = glob.glob(f"{tmp}/features/**/snapshot_cls0_it0.pt", recursive=True)[0]
            ADCustomDS.train_only, ADCustomDS.base_folder, ADCustomDS.classes = False, "custom", []
            t0 = time.perf_counter()
            _, res = inference_custom.main(common + ["--log-path", f"{tmp}/infer",
                                                     "--custom-model-snapshot", snap2])
            seconds["inference_custom"] = time.perf_counter() - t0
            counts = _counts()
            # ---- end of the counted run
            Trainer._init_or_load = init_or_load
            check_counts(counts, {}, "custom runners (no attention kernel)")
            params2 = torch.load(snap2, map_location="cpu", weights_only=True)["params"]
            for label, start, params in (("fresh", loaded[0], params1),
                                         ("from features", loaded[1], params2)):
                names = dict(WideResNetCustom(prediction_head=True).named_parameters())
                for k, v in params.items():
                    if k.startswith("feature_model.") and k in names:
                        check(torch.equal(v, start[k]), f"custom {label}: frozen {k} moved")
                    else:
                        check(not torch.equal(v, start[k]), f"custom {label}: {k} did not move")
            check(all(torch.equal(loaded[1][f"feature_model.{k}"], v) for k, v in features.items()),
                  "custom: the feature-model snapshot was not loaded")
            with open(glob.glob(f"{tmp}/features/log_*/print.txt")[0]) as f:
                check("Loaded pre-trained weights for feature model of CustomNet." in f.read(),
                      "custom: no feature-model load message")
            run = glob.glob(f"{tmp}/infer/log_*")[0]
            scores = _read_json(run, "eval_cls0_it0_anomaly_scores")
            specs = train_only_custom.build_specs(
                argparse.Namespace(image_resize=(256,), image_crop=(224, 224)), train=False)
            test_set = load_dataset("custom", data, [0], 0, specs, specs).test_set
            scorer = AnomalyScorer(snap2, WideResNetCustom(prediction_head=True),
                                   test_specs=specs, batch_size=BATCH)
            served = scorer.score(test_set.gather_all())
            got = np.asarray([scores[k] for k in test_set.sample_keys])
            serve_err = float(np.abs(served - got).max())
            check(len(scores) == CUSTOM_NORMAL + CUSTOM_ANOMALOUS and serve_err <= 1e-4,
                  f"custom inference_custom: AnomalyScorer differs by {serve_err} (tol 1e-4)")
            check(np.isfinite(res["mean_auc"]), f"custom inference_custom: AUROC {res}")
    finally:
        Trainer._init_or_load = init_or_load
        for k, v in saved_cls.items():
            setattr(ADCustomDS, k, v)
        DS_CHOICES["custom"] = saved_choice
    print(f"custom (WideResNetCustom, {CUSTOM_NORMAL} normal + {CUSTOM_ANOMALOUS} anomalous "
          f"64x64 PNGs at 224 px, frozen feature model): seconds of main "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }; every feature_model parameter "
          f"unchanged, the head and the batch-norm averages moved, in both runs; "
          f"inference_custom AUROC {res['mean_auc']:.4f}, its {len(scores)} scores keyed by "
          f"file equal AnomalyScorer's to {serve_err:.3g} (tol 1e-4) [{card}]")
    return counts


# ---------------------------------------------------------------- vmapped engines

VM_SEEDS, VM_EPOCHS = 4, 2           # train_cifar's defaults: 10 seeds, 200 epochs
VM_CLIP_SEEDS, VM_CLIP_EPOCHS = 2, 2  # one step of 128 + 128 per epoch on the synthetic class
VM_WRN_K, VM_WRN_STEPS = 2, 3
VM_PINNED_N = 2048                   # CNN32 seeds on phase 8's pinned CIFAR-10 stack
# the pinned Adam grid's hold: each member's parameters against its
# sequential seed's, over how far those moved from their init. On the CPU
# (128 + 128 CNN32 images, 2 epochs, 3 seeds) that reads 3.3e-3 to 3.9e-3
# with Adam and 4.4e-4 to 1.9e-3 with SGD: float noise in the order of
# summation. A member updated with another's moments or gradients drifts by
# the order of its own change, 1.
ADAM_DRIFT_TOL = 2 ** -4
# (d): a test pair whose order differs between the two evaluators is a tie
# when its two scores agree to 20 bits in both runs (16 fp32 ulps at their
# size). The hsc scores saturate near 1 (on the CPU a candidate's spread
# read 6.2e-5), so a tie there is a few ulps
TIE_TOL = 2 ** -20
VM_WRN_SEEDS, VM_WRN_POOL = 10, 16   # train_imagenet's seeds; one chunk of candidates
GA_POOL, GA_HW = 10_000, 256         # evolve_oe_imagenet's mutation pool of raw images


def _printed(run: str) -> str:
    with open(os.path.join(run, "print.txt")) as f:
        return f.read()


def _member_losses(run: str, epochs: int) -> dict:
    """Each epoch's loss of each seed, {(seed, epoch): loss}, as printed
    into print.txt."""
    import re
    return {(int(k), int(e)): float(v) for k, e, v in re.findall(
        rf"cls 0 seed (\d+) epoch (\d+)/{epochs}: loss ([0-9.]+)", _printed(run))}


class _SgdTrainers:
    """Within: every trainer updates with SGD at its own rate and schedule.
    The held runs of (a) and (d) use it: Adam's first updates are +-lr on
    every element, so float noise flips the sign of a near-zero gradient
    entry into a 2*lr difference (on the CPU, ``evolve.vmapped`` against the
    sequential evaluator at evolve_oe_cifar's settings: fitness 1.7e-8 apart
    with SGD, 2.8e-2 with Adam)."""

    def __enter__(self):
        from eoe_tpu_torch.training import Trainer
        from eoe_tpu_torch.training.optim import make_optimizer
        self.saved = Trainer.make_optimizer
        Trainer.make_optimizer = lambda tr, params, steps: make_optimizer(
            "sgd", params, tr.lr, tr.wdk, tr.milestones, steps)

    def __exit__(self, *exc):
        from eoe_tpu_torch.training import Trainer
        Trainer.make_optimizer = self.saved


class _SequentialSeeds:
    """Within: ``Trainer.run`` trains the seeds of a class one after another,
    as it did before the vmapped seeds."""

    def __enter__(self):
        from eoe_tpu_torch.training import Trainer
        self.saved = Trainer._try_vmap_seeds
        Trainer._try_vmap_seeds = lambda *a, **k: None

    def __exit__(self, *exc):
        from eoe_tpu_torch.training import Trainer
        Trainer._try_vmap_seeds = self.saved


def _test_labels(tmp: str):
    """The binary test labels of the synthetic CIFAR-10 class 0."""
    from eoe_tpu_torch.datasets import load_dataset
    normal = load_dataset("cifar10", os.path.join(tmp, "datasets"), [0], 0, [], [])
    return normal.binary_targets(normal.test_set)


def _member_drift(dirs: dict, seeds: list) -> list:
    """Per CNN32 member: the L2 distance of its vmapped run's parameters from
    its sequential seed's, over the distance the sequential seed's moved
    from their init; ``dirs`` holds each run's logger directory."""
    import torch
    from eoe_tpu_torch.models import CNN32
    names = [n for n, _ in CNN32().named_parameters()]
    out = []
    for k, seed in enumerate(seeds):
        init = CNN32()
        init.reset_parameters(torch.Generator().manual_seed(seed))
        p0 = init.state_dict()
        p = {m: torch.load(os.path.join(d, "snapshots", f"snapshot_cls0_it{k}.pt"),
                           weights_only=True)["params"] for m, d in dirs.items()}
        num = sum(((p["vmapped"][n] - p["sequential"][n]).double() ** 2).sum() for n in names)
        den = sum(((p["sequential"][n] - p0[n]).double() ** 2).sum() for n in names)
        out.append(float((num / den) ** 0.5))
    return out


def _timed_and_profiled(fn, logdir: str, path: str) -> tuple:
    """``fn("timed")`` timed with ``step_timer`` (the card synchronised), then
    ``fn("profiled")`` under ``profile``: (the first result, its seconds,
    seconds the card was busy in the profiled run). The launches the trace
    shows are held against the counters' increments over the profiled run
    and added to path ``path``'s traced launches."""
    import torch
    from eoe_tpu_torch.utils.profiling import device_seconds, profile, step_timer
    times = []
    with step_timer(times) as out:
        result = fn("timed")
        out["sync"] = torch.zeros(1, device="cuda")
    before = _counts()
    with profile(logdir) as prof:
        fn("profiled")
        torch.cuda.synchronize()
    after = _counts()
    hold_traced(prof, {k: after[k] - before[k] for k in after}, f"{path} (profiled run)", path)
    return result, times[0], device_seconds(prof)


def _vm_train_cifar(card: str, tmp: str) -> tuple:
    """(a) ``train_cifar`` by ``main`` with 4 seeds of class 0 for 2 epochs
    (SGD, see ``_SgdTrainers``), the default (vmapped) against
    ``--no-vmap-seeds``: each seed's AUROC in results.json to 1e-4; then 4
    CNN32 seeds with the trainer's Adam on phase 8's pinned 2048 + 2048
    CIFAR-10 stack through ``Trainer.run``, both ways, each member's
    parameters held against its sequential seed's (``ADAM_DRIFT_TOL``), and
    the same grid with SGD for the drift's floor. Counted: no kernel of the
    repository lies on this path."""
    import numpy as np
    import torch
    from eoe_tpu_torch.main import train_cifar
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.utils.logger import Logger

    argv = ["-e", str(VM_EPOCHS), "-it", str(VM_SEEDS), "--classes", "0", "--datapath", tmp]
    out = {}
    _zero_counts()
    for mode, flag in (("vmapped", []), ("sequential", ["--no-vmap-seeds"])):
        with _SgdTrainers():
            out[mode] = _timed_and_profiled(
                lambda tag: train_cifar.main(argv + flag + ["--superdir", f"{mode}_{tag}"]),
                os.path.join(tmp, f"trace_{mode}"), "vm_conv")
    counts = _counts()
    check_counts(counts, {}, "vmapped train_cifar (no attention kernel)")
    runs = {m: _run_dirs(tmp, f"{m}_*/log_*_hsc_cifar10_one_vs_rest") for m in out}
    check(all(len(r) == 2 for r in runs.values()), f"vmapped train_cifar: runs {runs}")
    printed = [_printed(r) for r in runs["vmapped"]]
    check(all(f"trained {VM_SEEDS} seeds of cls 0 vmapped" in p for p in printed),
          "vmapped train_cifar: the default did not train the seeds vmapped")
    check(not any("vmapped" in _printed(r) for r in runs["sequential"]),
          "vmapped train_cifar: --no-vmap-seeds trained vmapped")
    aucs = {m: np.array(_read_json(runs[m][0], "results")["eval_cls_rocs"][0]) for m in runs}
    err = float(np.abs(aucs["vmapped"] - aucs["sequential"]).max())
    check(aucs["vmapped"].shape == (VM_SEEDS,) and err <= 1e-4,
          f"vmapped train_cifar: per-seed AUROCs {aucs} differ by {err} (tol 1e-4)")
    for mode, (_, seconds, busy) in out.items():
        print(f"vmapped (a) train_cifar {mode} (SGD): {VM_SEEDS} seeds x {VM_EPOCHS} epochs of "
              f"class 0 (synthetic data) in {seconds:.3f} s of main; the card busy "
              f"{busy:.3f} s in the profiled run ({100 * busy / seconds:.1f}% of the timed "
              f"run) [{card}]")
    print(f"vmapped (a) train_cifar: per-seed AUROCs {aucs['vmapped'].round(6).tolist()}, "
          f"max difference to the sequential seeds {err:.3g} (tol 1e-4)")

    # the same grid at a size where the steps count: 16 steps per epoch
    from eoe_tpu_torch.training.trainer import _seed
    data = _pinned(np.random.default_rng(SEED), 32, VM_PINNED_N, CONV_TEST, CIFAR_SPECS,
                   ["normalize"])
    pinned = {}

    def run(mode, tag):
        trainer = _conv_trainer("hsc", CNN32(), CIFAR_SPECS, ["normalize"],
                                Logger(os.path.join(tmp, f"pinned_{mode}_{tag}"),
                                       noname=True), torch.float32, VM_EPOCHS)
        trainer.ds = data[0]
        return trainer.run(run_classes=[0], run_seeds=VM_SEEDS,
                           vmap_seeds=mode == "vmapped")[1]

    _zero_counts()
    for mode in ("vmapped", "sequential"):
        pinned[mode] = _timed_and_profiled(lambda tag: run(mode, tag),
                                           os.path.join(tmp, f"trace_pinned_{mode}"), "vm_conv")
    check_counts(_counts(), {}, "vmapped CNN32 pinned (no attention kernel)")
    with _SgdTrainers():
        for mode in ("vmapped", "sequential"):
            run(mode, "sgd")
    seeds = [_seed(0, 0, k, 0) for k in range(VM_SEEDS)]
    drift = {opt: _member_drift({m: os.path.join(tmp, f"pinned_{m}_{tag}")
                                 for m in ("vmapped", "sequential")}, seeds)
             for opt, tag in (("Adam", "timed"), ("SGD", "sgd"))}
    check(max(drift["Adam"]) <= ADAM_DRIFT_TOL,
          f"vmapped CNN32 pinned (Adam): members' parameters drift {drift['Adam']} of their "
          f"change from their sequential seeds' (tol {ADAM_DRIFT_TOL:.3g})")
    pin_aucs = {m: np.array(r[0]["cls_aucs"][0]) for m, r in pinned.items()}
    check(all(np.isfinite(a).all() and a.shape == (VM_SEEDS,) for a in pin_aucs.values()),
          f"vmapped CNN32 pinned: AUROCs {pin_aucs}")
    pin_err = float(np.abs(pin_aucs["vmapped"] - pin_aucs["sequential"]).max())
    for mode, (_, seconds, busy) in pinned.items():
        print(f"vmapped (a) CNN32 fp32 pinned {VM_PINNED_N}+{VM_PINNED_N} CIFAR-10 stack, "
              f"{VM_SEEDS} seeds x {VM_EPOCHS} epochs through Trainer.run, {mode}: "
              f"{seconds:.3f} s; the card busy {busy:.3f} s in the profiled run "
              f"({100 * busy / seconds:.1f}% of the timed run) [{card}]")
    print(f"vmapped (a) CNN32 pinned: per-seed synthetic AUROCs vmapped "
          f"{pin_aucs['vmapped'].round(6).tolist()}, max difference to the sequential seeds "
          f"{pin_err:.3g} (not held); each member's parameters against its sequential "
          f"seed's, over their change from the init: Adam "
          f"{[round(d, 6) for d in drift['Adam']]} (tol {ADAM_DRIFT_TOL:.3g}), SGD "
          f"{[round(d, 6) for d in drift['SGD']]} [{card}]")
    return counts


def _vm_wrn(card: str) -> dict:
    """(b) The WideResNet+CBAM bf16 step with the fused stem, two members for
    3 steps of 128 + 128 on the ImageNet-30 stack, each held against its
    sequential seed: losses to 2^-8 (relative), the first step's gradients
    to 2^-4 of their max; SGD at the trainer's rate. Peak memory per member,
    vmapped and sequential."""
    import torch
    import numpy as np
    from eoe_tpu_torch.models import WideResNet
    from eoe_tpu_torch.training import TrainState, vmapped_seeds as V
    from eoe_tpu_torch.training.optim import make_optimizer
    from eoe_tpu_torch.training.trainer import _seed
    from eoe_tpu_torch.utils.profiling import step_timer

    ds = _pinned(np.random.default_rng(SEED), 256, VM_WRN_STEPS * BATCH, 8, WRN_SPECS,
                 WRN_TEST_SPECS)[0]
    tr = _conv_trainer("hsc", WideResNet(), WRN_SPECS, WRN_TEST_SPECS, None, torch.bfloat16, 1)
    tr.make_optimizer = lambda params, steps: make_optimizer("sgd", params, tr.lr, tr.wdk, [],
                                                             steps)
    seeds = [_seed(SEED, 0, it, 0) for it in range(VM_WRN_K)]
    dev, rt = tr.device, tr._rt_stats(ds)
    Xn = torch.from_numpy(ds.train_set.gather_all()).to(dev)
    Xo = torch.from_numpy(ds.oe.train_set.gather_all()).to(dev)
    ln = torch.zeros(VM_WRN_K, BATCH, dtype=torch.int64, device=dev)
    lo = torch.ones(VM_WRN_K, BATCH, dtype=torch.int64, device=dev)
    w = torch.ones(VM_WRN_K, BATCH, device=dev)

    def batch(i):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        return (Xn[sl].expand(VM_WRN_K, *Xn[sl].shape),
                Xo[sl].expand(VM_WRN_K, *Xo[sl].shape))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts("vm_wrn")
    stack = tr.init_states_stacked(seeds, VM_WRN_STEPS)
    gens = [torch.Generator(device=dev).manual_seed(_seed(s, 2)) for s in seeds]
    losses, times, grads = [], [], None
    for i in range(VM_WRN_STEPS):
        xn, xo = batch(i)
        with step_timer(times) as out:
            if i == 0:   # the first step's gradients, from generators in the same state
                g0 = [torch.Generator(device=dev).manual_seed(_seed(s, 2)) for s in seeds]
                x = torch.cat([V.preprocess_members(tr, ds, xn, ln, g0, "normal", rt),
                               V.preprocess_members(tr, ds, xo, lo, g0, "oe", rt)], 1)
                grads = stack.grads(x.to(torch.bfloat16), torch.cat([ln, lo], 1),
                                    torch.cat([w, w], 1), None)[0]
                del x
            loss, *_ = V.stacked_step(tr, ds, stack, xn, ln, xo, lo, w, gens, None, rt)
            out["sync"] = loss
        losses.append(loss.float().cpu())
    counts = _counts()
    check_counts(counts, {}, "vmapped WideResNet (no attention kernel)")
    peak_vm = (torch.cuda.max_memory_allocated() - base) / VM_WRN_K
    del stack
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seq_losses, seq_times, l_err, g_diff, g_max, g_worst = [], [], 0.0, 0.0, 0.0, ""
    t_err, t_worst = 0.0, ""
    for k, seed in enumerate(seeds):
        st = tr.init_state(seed, ds, VM_WRN_STEPS)
        gen = torch.Generator(device=dev).manual_seed(_seed(seed, 2))
        for i in range(VM_WRN_STEPS):
            xn, xo = batch(i)
            with step_timer(seq_times) as out:
                loss, *_ = tr.train_step(st, ds, xn[0], ln[0], xo[0], lo[0], w[0], gen)
                out["sync"] = loss
            l_err = max(l_err, abs(loss.item() - losses[i][k].item()) / abs(loss.item()))
            if i == 0:   # the largest difference over the largest gradient entry
                for n, p in st.model.named_parameters():
                    ref = p.grad.float()
                    diff = (grads[n][k].float() - ref).abs().max().item()
                    own = ref.abs().max().item()
                    g_max = max(g_max, own)
                    if diff > g_diff:
                        g_diff, g_worst = diff, f"{n}, whose own max is {own:.3g}"
                    if diff / max(own, 1e-30) > t_err:
                        t_err, t_worst = diff / max(own, 1e-30), n
        seq_losses.append(loss.item())
        del st
    peak_seq = torch.cuda.max_memory_allocated() - base
    g_err = g_diff / max(g_max, 1e-30)
    check(l_err <= 2 ** -8, f"vmapped WideResNet: member losses differ by {l_err} (tol 2^-8)")
    check(g_err <= 2 ** -4, f"vmapped WideResNet: gradients differ by {g_err} of their max "
          f"({g_worst}; tol 2^-4)")
    print(f"vmapped (b) WideResNet+CBAM bf16 fused stem, {VM_WRN_K} members x {VM_WRN_STEPS} "
          f"steps of {BATCH}+{BATCH}: losses {[l.tolist() for l in losses]}, vs the "
          f"sequential seeds {l_err:.3g} rel (tol 2^-8); first-step gradients {g_err:.3g} of "
          f"max ({g_worst}; tol 2^-4; tensor by tensor, {t_worst} {t_err:.3g} of its own "
          f"max, not held); step {np.median(times[1:]) * 1e3:.1f} ms vmapped vs "
          f"{np.median(seq_times) * 1e3:.1f} ms per sequential seed step (median of the "
          f"steps after the first, host clock, synchronised); peak memory per member "
          f"{peak_vm / 2 ** 30:.2f} GiB vmapped, {peak_seq / 2 ** 30:.2f} GiB sequential "
          f"[{card}]")
    del grads
    torch.cuda.empty_cache()
    return counts


def _vm_clip(card: str, tmp: str) -> dict:
    """(c) ``train_clip_cifar --vmap-seeds`` with two seeds at full ViT-B/32
    width in bf16, counted: the fused forward and backward launch once per
    layer and step on the K*256 folded images (12 + 12 per step, not twice
    that), once per layer and eval batch on K*128, and once per text layer
    for each member's prompt centre; the memory probe adds two steps of one
    member (on 256) and two of two (on 512; an eager step and a replay of
    its captured graph) and one prompt centre. Each
    member's loss of each epoch within 2^-8 of ``--no-vmap-seeds``'s seed
    (a program of both: the run logs no "per program")."""
    import numpy as np
    import torch
    from eoe_tpu_torch.main import train_clip_cifar
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32, to_openai
    from eoe_tpu_torch.ops import attention as A

    ckpt = os.path.join(tmp, "ViT-B-32.pt")
    weights = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
    torch.save(to_openai(weights, VIT_B32), ckpt)
    del weights
    os.environ["EOE_TPU_CLIP_CHECKPOINT"] = ckpt
    argv = ["--epochs", str(VM_CLIP_EPOCHS), "--classes", "0", "-it", str(VM_CLIP_SEEDS),
            "--datapath", tmp]
    K, layers, text_layers = VM_CLIP_SEEDS, VIT_B32.vision_layers, VIT_B32.transformer_layers
    steps, eval_batches = VM_CLIP_EPOCHS, 1   # 20 synthetic normal images, 100 test images
    shapes, launch = [], A._fwd_kernel

    def recorded(qkv, heads, causal):
        shapes.append((qkv.shape[0], qkv.shape[1]))
        return launch(qkv, heads, causal)

    A._fwd_kernel = recorded
    try:
        # ---- the main path, counted
        _zero_counts("vm_clip")
        t0 = time.perf_counter()
        train_clip_cifar.main(argv + ["--vmap-seeds", "--superdir", "clip_vm"])
        t_vm = time.perf_counter() - t0
        counts = _counts()
        # ---- end of the counted run
    finally:
        A._fwd_kernel = launch
    # the memory probe (vmapped_seeds.seeds_per_program): two steps of one
    # member and two of two (an eager step and a replay of its captured
    # graph, as the program runs them), and the prompt centre once
    probe = {"fwd": text_layers + 4 * layers, "bwd": 4 * layers}
    check_counts(counts, {"fwd": (K + 1) * text_layers + layers * (steps + eval_batches + 4),
                          "bwd": layers * (steps + 4)},
                 f"vmapped train_clip_cifar ({K} members: {K * text_layers} prompt launches, "
                 f"{steps} folded steps, {eval_batches} folded eval batch; the probe {probe})")
    # the wrapper sees each call from Python: an eager step's and a
    # capture's, not a replay's (one-step graphs: the first step eager, the
    # second captured); the probe calls twice for each of its stacks
    calls = min(steps, 2)
    image = Counter(n for n, s in shapes if s != 77)
    check(image == {K * 2 * BATCH: layers * (calls + 2), K * BATCH: layers * (eval_batches + 2)},
          f"vmapped train_clip_cifar: image-tower calls by n {dict(image)}, expected "
          f"{layers * (calls + 2)} on {K * 2 * BATCH} (the steps' and the probe's two members') "
          f"and {layers * (eval_batches + 2)} on {K * BATCH} (eval and the probe's one)")
    _zero_counts()
    t0 = time.perf_counter()
    train_clip_cifar.main(argv + ["--no-vmap-seeds", "--superdir", "clip_seq"])
    t_seq = time.perf_counter() - t0
    seq_counts = _counts()
    runs = {m: _run_dirs(tmp, f"clip_{m}/log_*") for m in ("vm", "seq")}
    check(f"trained {K} seeds of cls 0 vmapped\n" in _printed(runs["vm"][0]),
          "vmapped train_clip_cifar: --vmap-seeds did not train the seeds vmapped")
    lv, ls = (_member_losses(runs[m][0], VM_CLIP_EPOCHS) for m in ("vm", "seq"))
    check(sorted(lv) == sorted(ls) == [(k, e + 1) for k in range(K)
                                       for e in range(VM_CLIP_EPOCHS)],
          f"vmapped CLIP: losses {lv}, {ls}")
    l_err = max(abs(lv[k] - ls[k]) / abs(ls[k]) for k in ls)
    check(l_err <= 2 ** -8, f"vmapped CLIP: member losses {lv} differ from the sequential "
          f"seeds' {ls} by {l_err} (tol 2^-8)")
    aucs = {m: _read_json(runs[m][0], "results")["eval_cls_rocs"][0] for m in runs}
    print(f"vmapped (c) train_clip_cifar ViT-B/32 bf16 --vmap-seeds, {K} seeds x {steps} steps "
          f"of {BATCH}+{BATCH}: {t_vm:.2f} s of main vs {t_seq:.2f} s with --no-vmap-seeds "
          f"(checkpoint load included); launches {counts} (the probe's {probe}) vs "
          f"{seq_counts}; image-tower launches by n {dict(image)}; losses by (seed, epoch) "
          f"{lv} vs {ls}, {l_err:.3g} rel "
          f"(tol 2^-8); "
          f"synthetic AUROCs {aucs['vm']} vs {aucs['seq']} [{card}]")
    torch.cuda.empty_cache()
    return counts


def _recorded_scores(mode: str, into: list):
    """Patches that record every test score array of an evolution run in
    ``into``: the sequential evaluator's ``Trainer.eval_scores`` (one per
    candidate and seed), or the vmapped evaluator's ``StackedState.scores``
    (one per chunk and test batch) grouped by ``evaluate_population`` call.
    Returns the function that restores them."""
    from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
    from eoe_tpu_torch.training import Trainer
    from eoe_tpu_torch.training.vmapped_seeds import StackedState
    if mode == "sequential":
        own = Trainer.eval_scores

        def eval_scores(self, state, ds):
            into.append(own(self, state, ds))
            return into[-1]
        Trainer.eval_scores = eval_scores
        return lambda: setattr(Trainer, "eval_scores", own)
    own, population = StackedState.scores, VmappedEvaluator.evaluate_population

    def scores(self, x, center):
        out = own(self, x, center)
        into[-1].append(out.cpu().numpy())
        return out

    def evaluate_population(self, individuals):
        into.append([])
        return population(self, individuals)
    StackedState.scores, VmappedEvaluator.evaluate_population = scores, evaluate_population

    def restore():
        StackedState.scores, VmappedEvaluator.evaluate_population = own, population
    return restore


def _by_candidate(mode: str, recorded: list, iterations: int, n_test: int):
    """The recorded scores as (evaluated candidate, seed, test image)."""
    import numpy as np
    if mode == "sequential":
        return np.stack(recorded).reshape(-1, iterations, n_test)
    calls = []
    for call in recorded:   # chunks in order, each its (padded) test batches in order
        chunks = []
        for arr in call:
            if not chunks or sum(a.shape[1] for a in chunks[-1]) >= n_test:
                chunks.append([])
            chunks[-1].append(arr)
        rows = np.concatenate([np.concatenate(c, 1)[:, :n_test] for c in chunks])
        calls.append(rows.reshape(iterations, -1, n_test).transpose(1, 0, 2))
    return np.concatenate(calls)


def _vm_evolve(card: str, tmp: str) -> dict:
    """(d) ``evolve_oe_cifar --ev-vmap`` at phase evolve's settings against
    the sequential evaluator with sequential seeds (``_SequentialSeeds``),
    both with SGD (``_SgdTrainers``): the same populations (the GA's picks)
    and each evaluated candidate's AUROC of each seed to 1e-4, or where not,
    every test pair whose order differs a tie (``TIE_TOL``), printed with
    its scores; seconds per evaluated individual and the card's busy time,
    each way; the peak memory per candidate. Counted: no kernel of the
    repository lies on this path."""
    import glob
    import re

    import numpy as np
    import torch
    from eoe_tpu_torch.main import evolve_oe_cifar
    from eoe_tpu_torch.ops.metrics import roc_curve

    one = ["--classes", "0", "--datapath", tmp]
    out, peaks, recorded = {}, {}, {}
    _zero_counts()
    for mode, flag in (("vmapped", ["--ev-vmap"]), ("sequential", [])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        recorded[mode] = []

        def run(tag):
            if tag == "timed":
                restore = _recorded_scores(mode, recorded[mode])
            try:
                with _SgdTrainers(), _SequentialSeeds():
                    return evolve_oe_cifar.main(EV_CIFAR + one + flag + [
                        "--superdir", f"{tmp}/ev_{mode}_{tag}"])
            finally:
                if tag == "timed":
                    restore()
        out[mode] = _timed_and_profiled(run, os.path.join(tmp, f"trace_ev_{mode}"),
                                        "vm_evolve")
        peaks[mode] = torch.cuda.max_memory_allocated() - base
    counts = _counts()
    check_counts(counts, {}, "vmapped evolve (no attention kernel)")
    (hv, _), (hs, _) = out["vmapped"][0], out["sequential"][0]
    check(hv["pop"] == hs["pop"], f"vmapped evolve: populations {hv['pop']} differ from the "
          f"sequential evaluator's {hs['pop']}")
    fit_err = float(np.abs(np.asarray(hv["fit"]) - np.asarray(hs["fit"])).max())
    labels = _test_labels(tmp)
    normal, anomalous = np.flatnonzero(labels == 0), np.flatnonzero(labels == 1)
    sc = {m: _by_candidate(m, recorded[m], 2, len(labels)) for m in recorded}
    check(sc["vmapped"].shape == sc["sequential"].shape,
          f"vmapped evolve: recorded scores {sc['vmapped'].shape} vs {sc['sequential'].shape}")
    err, ties = 0.0, []
    for j, it in np.ndindex(*sc["vmapped"].shape[:2]):
        s = {m: sc[m][j, it] for m in sc}
        auc = {m: roc_curve(labels, v).auc for m, v in s.items()}
        d = abs(auc["vmapped"] - auc["sequential"])
        err = max(err, d)
        if d <= 1e-4:
            continue
        order = {m: np.sign(v[anomalous][None] - v[normal][:, None]) for m, v in s.items()}
        for a, b in zip(*np.nonzero(order["vmapped"] != order["sequential"])):
            na, nb = normal[a], anomalous[b]
            for m, v in s.items():
                size = max(abs(float(v[na])), abs(float(v[nb])))
                check(abs(float(v[nb]) - float(v[na])) <= TIE_TOL * size,
                      f"vmapped evolve: candidate {j} seed {it} AUROC differs by {d}; test pair "
                      f"({na}, {nb}) is ordered differently, {m} scores {v[na]}, {v[nb]} "
                      f"(more than {TIE_TOL:.3g} of their size apart)")
            ties.append(f"candidate {j} seed {it} ({d:.3g}): test images {na} (normal), {nb} "
                        f"(anomalous) scored {s['vmapped'][na]:.9g}, {s['vmapped'][nb]:.9g} "
                        f"vmapped, {s['sequential'][na]:.9g}, {s['sequential'][nb]:.9g} "
                        f"sequential")
    n_eval = {}
    for mode in out:
        printed = "".join(_printed(r) for r in glob.glob(
            os.path.join(tmp, f"ev_{mode}_timed", "log_*_evolve_*")))
        n_eval[mode] = (sum(int(n) for n in re.findall(r"Evaluate (\d+) individuals", printed))
                        + printed.count("Evaluate ind"))
    check(n_eval["vmapped"] == n_eval["sequential"] == sc["vmapped"].shape[0] > 0,
          f"vmapped evolve: evaluated {n_eval}, scores of {sc['vmapped'].shape[0]}")
    for mode, (_, seconds, busy) in out.items():
        print(f"vmapped (d) evolve_oe_cifar {mode} ({' '.join(EV_CIFAR)}, SGD, sequential "
              f"seeds): {seconds:.3f} s of main, {n_eval[mode]} individuals, "
              f"{seconds / n_eval[mode]:.4f} s per individual (PERF.md: phase evolve "
              f"took 0.121-0.127 s before the vmapped engines); the card busy {busy:.3f} s in the profiled run "
              f"({100 * busy / seconds:.1f}% of the timed run); peak memory "
              f"{peaks[mode] / 2 ** 20:.1f} MiB [{card}]")
    print(f"vmapped (d) evolve: populations equal; each candidate's AUROC of each seed max "
          f"difference {err:.3g} (tol 1e-4, else ties within {TIE_TOL:.3g} relative: "
          f"{'; '.join(ties) or 'none'}); fitness max difference {fit_err:.3g}; peak memory "
          f"per candidate of a chunk of {EV_CIFAR[1]}: "
          f"{peaks['vmapped'] / int(EV_CIFAR[1]) / 2 ** 20:.1f} MiB")
    return counts


def _vm_folded_calls(card: str):
    """(e) One folded call of each kernel under ``torch.func.vmap`` at K=2 on
    the training shape, against the unfolded kernel on each member: exact for
    the fused kernels (both grids, forward and backward), 1e-5 for flash in
    fp32 (bf16: 2^-8 of the max)."""
    import torch
    from torch.func import vmap
    from eoe_tpu_torch.ops import attention as A

    n, s, h, d, causal = SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    before = _counts()
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(2, n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
        dout = torch.randn(2, n, s, h * d, generator=g, device="cuda").to(dtype)
        for name, fwd, bwd in (("monolithic", A._fwd_kernel, A._bwd_kernel),
                               ("group", A._group_fwd_kernel, A._group_bwd_kernel)):
            folded = vmap(lambda x: A._QkvAttention.apply(x, h, causal, fwd, bwd))(qkv)
            folded_b = vmap(lambda x, y: A._QkvAttentionBwd.apply(x, y, h, causal, bwd))(
                qkv, dout)
            for k in range(2):
                check(torch.equal(folded[k], fwd(qkv[k], h, causal)),
                      f"folded {name} forward {dtype}: member {k} differs")
                check(torch.equal(folded_b[k], bwd(qkv[k], dout[k], h, causal)),
                      f"folded {name} backward {dtype}: member {k} differs")
            lines.append(f"{name} {str(dtype)[6:]} fwd+bwd exact")
        q, k_, v = (torch.randn(2, n, h, s, d, generator=g, device="cuda").to(dtype)
                    for _ in range(3))
        folded = vmap(lambda a, b, c: A._FlashAttention.apply(a, b, c, None, A._flash_kernel))(
            q, k_, v)
        err = max((folded[m].float() - A._flash_kernel(q[m], k_[m], v[m], None).float())
                  .abs().max().item() for m in range(2))
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8
        check(err <= tol, f"folded flash {dtype}: members differ by {err} (tol {tol})")
        lines.append(f"flash {str(dtype)[6:]} {err:.3g} (tol {tol:.3g})")
    after = _counts()
    folded_launches = {key: after[key] - before[key] for key in ("fwd", "bwd", "group_fwd",
                                                                 "group_bwd", "flash")}
    check(all(v == 6 for v in folded_launches.values()),
          f"folded calls: launches {folded_launches}, expected 6 of each kernel (per dtype "
          f"one folded call and one per member)")
    print(f"vmapped (e) folded calls at K=2, n={n} s={s} H={h} d={d} (K*n={2 * n} in one "
          f"launch) against each member's own launch: {'; '.join(lines)}; comparison "
          f"launches {folded_launches} [{card}]")


def _vm_wrn_runners(card: str, tmp: str) -> dict:
    """(f) The WideResNet+CBAM runners in fp32 at their published width,
    batch 128 + 128 at 224 px, on the ImageNet-30 and -21k blobs:
    ``train_imagenet`` with its 10 seeds of class 0 for 1 epoch (2 steps;
    the default: 150), OE cut to 256 images, by default against
    ``--no-vmap-seeds``; then ``evolve_oe_imagenet --ev-vmap`` with one
    generation of 16 candidates (the default: 64) for 1 epoch. The members
    each program holds come from the measured peaks of one and of two
    (``vmapped_seeds.members_that_fit``, printed); each run's peak memory
    (allocated, and reserved: a capture's pool beside segments the eager
    steps keep) and seconds. Counted: no attention kernel lies on this path; the stacked
    ``train_imagenet`` traced."""
    from contextlib import nullcontext

    import numpy as np
    import torch
    from eoe_tpu_torch.main import evolve_oe_imagenet, train_imagenet
    from eoe_tpu_torch.training import vmapped_seeds as V

    _folder_data(os.path.join(tmp, "datasets"))
    fits, fit = [], V.members_that_fit

    def recorded(peaks, free, wanted):
        fits.append((peaks, free, wanted, fit(peaks, free, wanted)))
        return fits[-1][-1]

    seeds = ["-e", "1", "-it", str(VM_WRN_SEEDS), "--oe-size", "256"]
    runs = (("train_imagenet", "grid", train_imagenet.main, seeds),
            ("train_imagenet --no-vmap-seeds", "grid_seq", train_imagenet.main,
             seeds + ["--no-vmap-seeds"]),
            ("evolve_oe_imagenet --ev-vmap", "ev_wrn", evolve_oe_imagenet.main,
             ["--ev-vmap", "--ev-generation-pool", str(VM_WRN_POOL), "--ev-generations", "1",
              "--epochs", "1"]))
    out = {}
    V.members_that_fit = recorded
    try:
        _zero_counts()
        for label, sub, fn, argv in runs:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            n = len(fits)
            t0 = time.perf_counter()
            # the traced part: the stacked seed grid (a trace of all three
            # took a minute of host time to read)
            with _Traced("vm_wrn_runners") if sub == "grid" else nullcontext():
                res = fn(argv + ["--classes", "0", "--datapath", tmp, "--superdir", sub])
            seconds = time.perf_counter() - t0
            out[label] = (res, seconds, torch.cuda.max_memory_allocated() - base, fits[n:],
                          torch.cuda.max_memory_reserved())
        counts = _counts()
    finally:
        V.members_that_fit = fit
    check_counts(counts, {}, "vmapped WideResNet runners (no attention kernel)")
    grid = {m: _run_dirs(tmp, f"{m}/log_*") for m in ("grid", "grid_seq")}
    printed = _printed(grid["grid"][0])
    check(f"trained {VM_WRN_SEEDS} seeds of cls 0 vmapped" in printed,
          f"vmapped train_imagenet: the {VM_WRN_SEEDS} seeds did not train vmapped")
    for label in ("train_imagenet", "train_imagenet --no-vmap-seeds"):
        aucs = np.asarray(out[label][0][1]["cls_aucs"][0], dtype=np.float64)
        check(aucs.shape == (VM_WRN_SEEDS,) and np.isfinite(aucs).all(),
              f"{label}: AUROCs {aucs}")
    fitness = np.asarray(out["evolve_oe_imagenet --ev-vmap"][0][0]["fit"], dtype=np.float64)
    check(fitness.shape == (1, VM_WRN_POOL) and np.isfinite(fitness).all(),
          f"evolve_oe_imagenet --ev-vmap: fitness {fitness}")
    total = torch.cuda.get_device_properties(0).total_memory
    for label, (_, seconds, peak, measured, reserved) in out.items():
        probe = "; ".join(
            f"{wanted} wanted, {n} per program (one member {p[0] / 2 ** 30:.2f} GiB, two "
            f"{p[1] / 2 ** 30:.2f} GiB, {(p[1] - p[0]) / 2 ** 30:.2f} GiB a member; "
            f"{free / 2 ** 30:.2f} GiB free)" for p, free, wanted, n in measured[:1])
        print(f"vmapped (f) {label} (WideResNet+CBAM fp32, {BATCH}+{BATCH} at 224 px): "
              f"{seconds:.2f} s of main; peak memory {peak / 2 ** 30:.2f} GiB, reserved "
              f"{reserved / 2 ** 30:.2f} of the card's {total / 2 ** 30:.2f} GiB; "
              f"{probe or 'no program sized'} [{card}]")
    print(f"vmapped (f) train_imagenet: {printed.count('seeds of cls 0 vmapped')} vmapped "
          f"class, log '{[ln for ln in printed.splitlines() if 'seeds of cls 0' in ln][0]}'; "
          f"evolve_oe_imagenet --ev-vmap fitness {fitness.round(4).tolist()}")
    return counts


def phase_vmapped(card: str) -> tuple:
    """The vmapped engines: (a) the CNN32 seed grid, (b) the WideResNet
    members' step, (c) CLIP's seeds through the folded fused kernels, (d) the
    evolve generation, (e) one folded call per kernel, (f) the WideResNet
    runners sized to the card. Each of (a)-(d) and (f) is a counted path."""
    import tempfile
    saved = {k: os.environ.get(k) for k in ("EOE_TPU_FAKE_DATA", "EOE_TPU_CLIP_CHECKPOINT")}
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            conv = _vm_train_cifar(card, tmp)
            wrn = _vm_wrn(card)
            clip = _vm_clip(card, tmp)
            evolve = _vm_evolve(card, tmp)
            _vm_folded_calls(card)
            runners = _vm_wrn_runners(card, tmp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return conv, wrn, clip, evolve, runners


def phase_ga_distances(card: str):
    """The GA's mutation (one sample) and mating (a pair) distances to
    evolve_oe_imagenet's mutation pool of 10,000 raw 256x256 images on the
    card: the peak memory of the chunked distances against the unchunked
    form (all candidates moved, differenced and squared at once), and their
    values against each other."""
    import numpy as np
    import torch
    from eoe_tpu_torch import evolve as ev
    from eoe_tpu_torch.datasets.bases import ArraySource, Subset

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 256, (GA_POOL, GA_HW, GA_HW, 3), generator=g, device="cuda",
                      dtype=torch.uint8).cpu().numpy()
    oeds = Subset(ArraySource(x, np.zeros(GA_POOL)), np.arange(GA_POOL))
    ids = [int(i) for i in np.random.default_rng(SEED).integers(0, GA_POOL, GA_POOL)]
    peaks, lines = {}, []
    for what, rows in (("mutation", [7]), ("mating", [7, 11])):
        a = ev._gather_f32(oeds, rows, "cuda")
        d = {}
        for form, fn in (("unchunked", lambda: ev._sq_dists(a, ev._gather_f32(oeds, ids, "cuda"))),
                         ("chunked", lambda: ev._candidate_dists(a, oeds, ids, "cuda"))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            d[form] = fn()
            seconds = time.perf_counter() - t0
            peaks[(what, form)] = torch.cuda.max_memory_allocated() - base
            lines.append(f"{what} {form}: peak {peaks[(what, form)] / 2 ** 30:.3f} GiB, "
                         f"{seconds:.2f} s")
        rel = float((np.abs(d["chunked"] - d["unchunked"])
                     / np.maximum(d["unchunked"], 1e-30)).max())
        check(rel <= 1e-6, f"GA distances: chunked {what} differs by {rel} relative")
        lines.append(f"{what} chunked vs unchunked {rel:.3g} relative")
        del a, d
    print(f"ga_distances, {GA_POOL} candidates of {GA_HW}x{GA_HW}x3 (DIST_CHUNK "
          f"{ev.DIST_CHUNK}): " + "; ".join(lines) + f" [{card}]")
    del x, oeds
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- clip_rn50

RN50_EPOCHS = 3            # one step of 128 + 128 each on the fake class 0 (the runner: 100)
RN50_STEPS, RN50_PROFILED = 5, 3   # timed and profiled steps of the step measurement


def phase_clip_rn50(card: str) -> dict:
    """CLIP RN50 at its published width (embed 1024, stages (3, 4, 6, 3),
    width 64, 224 px; text width 512, 12 layers, 8 heads) with random
    weights from seed 0, written as an OpenAI-style fp16 checkpoint:
    ``train_clip_cifar`` through its ``main`` in bf16 on the synthetic
    CIFAR-10 class 0 (the runner takes the tower from the checkpoint's
    shapes), counted: 12 fused forward launches for the prompt centre, none
    in the ResNet tower. Its snapshot served through ``AnomalyScorer``
    against its eval scores (1e-4); the fp32 centre through the kernel
    against the plain attention (1e-4), 12 launches a centre; one fp32
    request of 256 raw images; the bf16 step's ms, img/s, the card's busy
    share and peak memory. Also reports whether the run wrote tensorboard
    events or took the logger's fall-back."""
    import tempfile
    saved = {k: os.environ.get(k) for k in ("EOE_TPU_FAKE_DATA", "EOE_TPU_CLIP_CHECKPOINT")}
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return _clip_rn50(card, tmp)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rn50_step(card: str, ckpt: str):
    """The RN50 ``ClipTrainer`` bf16 step on phase 5's raw 256x256 images,
    128 + 128 a step: ``RN50_STEPS`` steps timed after two warm ones, then
    ``RN50_PROFILED`` profiled; the peak memory of the steps."""
    import tempfile
    import numpy as np
    import torch
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.utils.profiling import device_seconds, profile, step_timer
    trainer = TRAINER["clip"](None, None, None, dataset="cifar10", oe_dataset="cifar100",
                              datapath="", logger=None, epochs=1, lr=1e-4, wdk=1e-3,
                              milestones=[], batch_size=BATCH, checkpoint_path=ckpt,
                              compute_dtype=torch.bfloat16)
    ds, _ = _combined(np.random.default_rng(SEED), trainer.train_specs)
    state = trainer.init_state(0, ds, 1)
    center = trainer.prepare_metric("airplane", ds, state, 0)
    xn = torch.from_numpy(ds.train_set.gather_all()).cuda()
    xo = torch.from_numpy(ds.oe.train_set.gather_all()).cuda()
    labels = (torch.zeros(BATCH, dtype=torch.int64, device="cuda"),
              torch.ones(BATCH, dtype=torch.int64, device="cuda"))
    w = torch.ones(BATCH, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_batches = len(xn) // BATCH

    def step(i):
        sl = slice((i % n_batches) * BATCH, (i % n_batches + 1) * BATCH)
        return trainer.train_step(state, ds, xn[sl], labels[0], xo[sl], labels[1], w, gen,
                                  center)[0]

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    with step_timer(times) as out:
        losses = [step(i) for i in range(RN50_STEPS)]
        out["sync"] = losses[-1]
    peak = torch.cuda.max_memory_allocated() - base
    with tempfile.TemporaryDirectory() as logdir, profile(logdir) as prof:
        for i in range(RN50_PROFILED):
            step(i)
        torch.cuda.synchronize()
    busy = device_seconds(prof) / RN50_PROFILED
    ms = times[0] / RN50_STEPS * 1e3
    check(np.isfinite(torch.stack(losses).float().cpu().numpy()).all(),
          "clip_rn50 step: non-finite losses")
    print(f"clip_rn50 step (bf16, {BATCH}+{BATCH} raw 256x256 images at 224 px, "
          f"{RN50_STEPS} steps after 2 warm ones): {ms:.2f} ms a step = "
          f"{2 * BATCH / ms * 1e3:.1f} img/s on the host clock; the card busy "
          f"{busy * 1e3:.2f} ms a step in {RN50_PROFILED} profiled steps "
          f"({100 * busy * 1e3 / ms:.1f}% of the timed step); peak memory of the steps "
          f"{(peak + base) / 2 ** 30:.2f} GiB ({peak / 2 ** 30:.2f} GiB above the resident "
          f"weights and data) [{card}]")
    del trainer, state, xn, xo
    torch.cuda.empty_cache()


def _clip_rn50(card: str, tmp: str) -> dict:
    import numpy as np
    import torch
    from eoe_tpu_torch.datasets import load_dataset
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.main import train_clip_cifar
    from eoe_tpu_torch.models.clip import CLIP, RN50, from_openai, to_openai
    from eoe_tpu_torch.ops.attention import fused_qkv_attention_ref
    from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "RN50.pt")
    weights = CLIP(RN50, generator=torch.Generator().manual_seed(SEED)).state_dict()
    torch.save(to_openai(weights, RN50), ckpt)
    start = from_openai(torch.load(ckpt, weights_only=True))
    del weights
    print(f"clip_rn50: OpenAI-format fp16 RN50 checkpoint from seed {SEED}, "
          f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB, in {time.perf_counter() - t0:.1f} s")
    os.environ["EOE_TPU_CLIP_CHECKPOINT"] = ckpt
    normal = load_dataset("cifar10", os.path.join(tmp, "datasets"), [0], 0, [], [])
    steps = RN50_EPOCHS * -(-len(normal.train_set) // BATCH)
    n_test = len(normal.test_set)
    text_layers = RN50.transformer_layers

    # ---- the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts("clip_rn50")
    t0 = time.perf_counter()
    _, res = train_clip_cifar.main(["--epochs", str(RN50_EPOCHS), "--classes", "0", "-it", "1",
                                    "--datapath", tmp])
    seconds = time.perf_counter() - t0
    counts = _counts()
    # ---- end of the counted run
    peak_main = torch.cuda.max_memory_allocated()
    check_counts(counts, {"fwd": text_layers},
                 f"clip_rn50 train_clip_cifar ({text_layers} prompt-centre launches; the "
                 f"ResNet tower and its attention pool launch none)")
    run = _run_dirs(tmp, f"log_*_clip_cifar10_one_vs_rest_E{RN50_EPOCHS}")[0]
    results = _read_json(run, "results")
    check(np.isfinite(results["eval_mean_auc"]), f"clip_rn50: results {results}")
    setup = _read_json(run, "setup")
    check(setup["compute_dtype"] == "bfloat16", f"clip_rn50: setup {setup}")
    eval_scores = np.array([v for _, v in sorted(
        (int(k), v) for k, v in _read_json(run, "eval_cls0_it0_anomaly_scores").items())])
    snapshot = torch.load(os.path.join(run, "snapshots", "snapshot_cls0_it0.pt"),
                          map_location="cpu", weights_only=True)
    params = snapshot["params"]
    moved = [k for k in params if k.endswith("running_mean")
             and not torch.equal(params[k], start[k])]
    check(len(moved) == sum(k.endswith("running_mean") for k in params),
          f"clip_rn50: only {len(moved)} batch norms moved their averages")
    check(all(torch.equal(params[k], start[k]) for k in params if k.startswith("transformer.")),
          "clip_rn50: the text tower changed in training")
    tb = os.path.isdir(os.path.join(run, "tb"))
    try:
        import torch.utils.tensorboard  # noqa: F401
        importable = True
    except Exception:
        importable = False
    check(tb == importable, f"clip_rn50: tb/ written {tb}, tensorboard importable {importable}")
    print(f"tensorboard: {'tb/ events written' if tb else 'no tensorboard package: the '}"
          f"{'' if tb else 'logger fell back to scalars.json alone'} in the clip_rn50 run")

    # the snapshot served, in the run's dtype, against its eval scores
    test_specs = [{"op": "clip_pil_preprocessing", "resolution": RN50.image_resolution},
                  {"op": "clip_tensor_preprocessing"}]
    model = CLIP(RN50, dtype=torch.bfloat16)
    model.load_state_dict(params)
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH,
                           center=prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS),
                           compute_dtype=torch.bfloat16, test_specs=test_specs)
    served = scorer.score(normal.test_set.gather_all())
    serve_err = float(np.abs(served - eval_scores).max())
    check(eval_scores.shape == (n_test,) and serve_err <= 1e-4,
          f"clip_rn50: AnomalyScorer differs from the run's scores by {serve_err}")
    del model, scorer

    # the fp32 centre: the kernel against its plain version, 12 launches a centre
    m32 = CLIP(RN50)
    m32.load_state_dict(params)
    plain = CLIP(RN50, qkv_attention=fused_qkv_attention_ref)
    plain.load_state_dict(params)
    before = _counts()["fwd"]
    center = prompt_center(m32, CIFAR10_LABELS[0], CIFAR10_LABELS)
    per_centre = _counts()["fwd"] - before
    check(per_centre == text_layers,
          f"clip_rn50: {per_centre} fused forward launches for one centre, expected "
          f"{text_layers}")
    center_plain = prompt_center(plain, CIFAR10_LABELS[0], CIFAR10_LABELS)
    check(_counts()["fwd"] - before == text_layers, "clip_rn50: the plain centre launched")
    center_err = float((center - center_plain).abs().max())
    check(center_err <= 1e-4, f"clip_rn50: the kernel's fp32 centre differs from the plain "
          f"attention's by {center_err}")
    del plain

    # one fp32 request of 256 raw images
    scorer = AnomalyScorer(snapshot, m32, objective="clip", batch_size=BATCH, center=center,
                           test_specs=test_specs)
    images = np.random.default_rng(SEED).integers(0, 256, (REQUESTS[0], 32, 32, 3),
                                                  dtype=np.uint8)
    scorer.score(images)
    t0 = time.perf_counter()
    scores = scorer.score(images)
    t_req = time.perf_counter() - t0
    check(scores.shape == (REQUESTS[0],) and np.isfinite(scores).all(),
          "clip_rn50: bad fp32 request scores")
    print(f"clip_rn50 train_clip_cifar (RN50 bf16, cifar10 class 0, tinyimages OE, synthetic "
          f"data): {steps} steps in {seconds:.2f} s of main with the checkpoint load, img/s "
          f"per epoch {_epoch_rates(run)}, peak memory {peak_main / 2 ** 30:.2f} GiB; synthetic "
          f"AUROC {results['eval_mean_auc']:.4f}; {len(moved)} batch norms moved their "
          f"averages, the text tower unchanged; snapshot served through AnomalyScorer, max "
          f"score difference {serve_err:.3g} (tol 1e-4); fp32 centre, kernel vs plain "
          f"attention {center_err:.3g} (tol 1e-4), {per_centre} launches; fp32 request of "
          f"{REQUESTS[0]} images {t_req * 1e3:.1f} ms = {REQUESTS[0] / t_req:.1f} img/s; "
          f"launches {counts} [{card}]")
    del m32, scorer, snapshot, params, start
    torch.cuda.empty_cache()
    _rn50_step(card, ckpt)
    return counts


# ---------------------------------------------------------------- import

_WRN_REFERENCE_NAMES = [(r"layer(\d)_block(\d)", r"layer\1.\2"), (r"down_conv", "downsample.0"),
                        (r"down_bn", "downsample.1"),
                        (r"channel_gate\.mlp_hidden", "ChannelGate.mlp.1"),
                        (r"channel_gate\.mlp_out", "ChannelGate.mlp.3"),
                        (r"spatial_gate\.spatial_conv", "SpatialGate.spatial.conv"),
                        (r"spatial_gate\.spatial_bn", "SpatialGate.spatial.bn")]
# name, runner, the model it builds, its image side, its epochs, the source's
# weights scaled by 0.1 (the last layer carried, so that the features stay near
# unit norm and HSC's scores 1 - exp(-|f|) do not saturate at 1)
IMPORT_RUNS = (("cnn32", "train_cifar", "CNN32", 32, 1, r"^fc2\."),
               ("wrn_cbam", "train_imagenet", "WideResNet", 224, 1, r"^fc\."),
               ("wrn50_trunk", "train_imagenet", "WideResNet50Pretrained", 224, 0,
                r"^layer4_\d+\.(bn3|down_bn)\.weight$"))


def _reference_state(model, name_of, seed: int, side: int, shrink: str) -> tuple:
    """(the port model's weights, the same under the reference's torch names
    (``name_of``; None drops an entry) with torch's ``num_batches_tracked``
    counters). The weights are the model's init from ``seed``, those matching
    ``shrink`` scaled by 0.1; the batch-norm averages are the statistics of
    16 seeded normal images of ``side`` x ``side`` (as a trained net's are
    its data's: each batch norm's momentum set to 0 for one training-mode
    forward)."""
    import re
    import torch
    from eoe_tpu_torch.models.layers import BatchNorm
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.cuda()
    norms = [(m, m.momentum) for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for k, p in model.named_parameters():
            if re.search(shrink, k):
                p.mul_(0.1)
        for m, _ in norms:
            m.momentum = 0.0
        x = torch.randn(16, side, side, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
        model.train()(x)
    for m, momentum in norms:
        m.momentum = momentum
    source = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ref = {}
    for k, v in source.items():
        k = name_of(k)
        if k is None:
            continue
        ref[k] = v.clone()
        if k.endswith(".running_mean"):
            ref[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(100)
    return source, ref


def _reference_payload(name: str, net: dict) -> dict:
    """What the reference saves for ``name``: CNN32's and WideResNet+CBAM's
    training snapshots (CNN32's fc1 on the NCHW flatten), the trunk as
    torchvision's bare state dict with its 1000-way head (not carried)."""
    import torch
    if name == "cnn32":
        w = net["fc1.weight"]
        net["fc1.weight"] = w.reshape(w.shape[0], 4, 4, 128).permute(0, 3, 1, 2) \
            .reshape(w.shape[0], -1).contiguous()
        return {"net": net, "opt": None, "sched": None, "epoch": 1,
                "ds_statistics": {"mean": torch.tensor([0.49, 0.48, 0.45]),
                                  "std": torch.tensor([0.25, 0.24, 0.26])}}
    if name == "wrn_cbam":
        return {"net": net, "epoch": 1}
    return {**net, "fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}


class _Built:
    """``runner.build_model`` swapped for ``models.<cls>``, whose forward
    records its evaluation-mode inputs and outputs into ``recorded``."""

    def __init__(self, runner, cls: str, recorded=None):
        self.runner, self.cls, self.recorded = runner, cls, recorded

    def build(self, args):
        from eoe_tpu_torch import models
        model = getattr(models, self.cls)(clf=args.objective in ("bce", "focal"))
        if self.recorded is not None:
            model.register_forward_hook(lambda m, inp, out: None if m.training else
                                        self.recorded.append((inp[0].detach(), out.detach())))
        return model

    def __enter__(self):
        self.saved, self.runner.build_model = self.runner.build_model, self.build

    def __exit__(self, *exc):
        self.runner.build_model = self.saved


def phase_import(card: str) -> dict:
    """Reference-style torch snapshots at full width through
    ``python -m eoe_tpu_torch.main.import_snapshot``'s ``main``: CNN32 (fc1
    on the reference's c-major flatten), WideResNet+CBAM (2, 2, 2, 2) and a
    bare ``wide_resnet50_2`` trunk at (3, 4, 6, 3) with torchvision's names
    (``resnet50.trunk_keys`` inverted, so that no torchvision is needed).
    Each replaces the snapshot of a run of its runner (``train_cifar``,
    ``train_imagenet``; for the trunk, which no runner builds,
    ``train_imagenet`` with its ``build_model`` swapped for
    ``WideResNet50Pretrained`` and 0 epochs), and that runner's ``--load``
    evaluates it on the card. The features that evaluation computed must
    equal, within 1e-4 of their largest entry, those of the same model
    built by ``load_state_dict`` from the source, on the same images; its
    scores must equal the ones the run wrote and must not be constant; the
    snapshot the run writes holds the imported parameters, equal to the
    sources (the trunk's, beside a fresh head). Counted: no kernel of the
    repository lies on this path."""
    import glob
    import importlib
    import tempfile
    import numpy as np
    import torch
    from eoe_tpu_torch import models
    from eoe_tpu_torch.main import import_snapshot
    from eoe_tpu_torch.models.resnet50 import trunk_keys
    from eoe_tpu_torch.ops.losses import hsc_score

    def wrn_name(k):
        import re
        for pattern, repl in _WRN_REFERENCE_NAMES:
            k = re.sub(pattern, repl, k)
        return k
    torchvision_name = {port: tv for tv, port in trunk_keys((3, 4, 6, 3)).items()}.get
    name_of = {"cnn32": lambda k: k, "wrn_cbam": wrn_name, "wrn50_trunk": torchvision_name}
    runners = {name: importlib.import_module(f"eoe_tpu_torch.main.{runner}")
               for name, runner, *_ in IMPORT_RUNS}
    saved = os.environ.get("EOE_TPU_FAKE_DATA")
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    lines, sources, refs, runs, evaluated = [], {}, {}, {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _folder_data(os.path.join(tmp, "datasets"))
            for i, (name, _, cls, side, epochs, shrink) in enumerate(IMPORT_RUNS):
                sources[name], net = _reference_state(
                    getattr(models, cls)(), name_of[name], SEED + 1 + i, side, shrink)
                refs[name] = _reference_payload(name, net)
                # the run whose snapshot the import replaces
                with _Built(runners[name], cls):
                    runners[name].main(["-e", str(epochs), "--classes", "0", "-it", "1",
                                        "--oe-size", "256", "--datapath", tmp,
                                        "--superdir", name, "--no-vmap-seeds"])
                (runs[name],) = glob.glob(os.path.join(tmp, "results", name, "log_*"))
            # ---- the main path, counted
            _zero_counts("import")
            t0 = time.perf_counter()
            for name, _, cls, *_ in IMPORT_RUNS:
                src = os.path.join(tmp, f"{name}_reference.pt")
                torch.save(refs[name], src)
                t1 = time.perf_counter()
                import_snapshot.main(
                    [src, os.path.join(runs[name], "snapshots", "snapshot_cls0_it0.pt")])
                lines.append(f"{name} {os.path.getsize(src) / 2 ** 20:.1f} MiB imported in "
                             f"{time.perf_counter() - t1:.2f} s")
                recorded = []
                with _Built(runners[name], cls, recorded):
                    _, res = runners[name].main(["--load", runs[name], "--datapath", tmp])
                cont = runs[name] + "---CNTD"
                written = _read_json(cont, "eval_cls0_it0_anomaly_scores")
                evaluated[name] = (res["mean_auc"], torch.load(
                    os.path.join(cont, "snapshots", "snapshot_cls0_it0.pt"),
                    map_location="cpu", weights_only=True), recorded,
                    np.asarray(list(written.values()), dtype=np.float64))
            seconds = time.perf_counter() - t0
            counts = _counts()
            # ---- end of the counted run
    finally:
        if saved is None:
            os.environ.pop("EOE_TPU_FAKE_DATA", None)
        else:
            os.environ["EOE_TPU_FAKE_DATA"] = saved
    check_counts(counts, {}, "import (no attention kernel)")
    for name, _, cls, *_ in IMPORT_RUNS:
        auc, snap, recorded, written = evaluated[name]
        source = sources[name]
        params = snap["params"]
        keys = [k for k in source if not (name == "wrn50_trunk" and k.startswith("fc."))]
        check(all(torch.equal(params[k], source[k]) for k in keys),
              f"import {name}: the evaluated parameters differ from the source's")
        if name == "wrn50_trunk":
            check(not torch.equal(params["fc.weight"], source["fc.weight"]),
                  "import wrn50_trunk: the head is not fresh")
            source = {**source, **{k: params[k] for k in params if k.startswith("fc.")}}
        check(len(recorded) > 0, f"import {name}: the runner evaluated nothing")
        model = getattr(models, cls)()
        model.load_state_dict(source)
        model = model.cuda().eval()
        err, feats = 0.0, []
        with torch.no_grad():
            for x, y in recorded:
                want = model(x).float()
                err = max(err, float((y.float() - want).abs().max() / want.abs().max()))
                feats.append((y.float(), want))
        run_scores = hsc_score(torch.cat([y for y, _ in feats])).double().cpu().numpy()
        ref_scores = hsc_score(torch.cat([w for _, w in feats])).double().cpu().numpy()
        n = len(written)
        score_err = float(np.abs(run_scores[:n] - ref_scores[:n]).max())
        written_err = float(np.abs(run_scores[:n] - written).max())
        check(err <= 1e-4, f"import {name}: the evaluated features differ from the source "
                           f"model's by {err:.3g} of their largest entry (tol 1e-4)")
        check(score_err <= 1e-4 and written_err <= 1e-4,
              f"import {name}: scores differ from the source model's by {score_err:.3g} and "
              f"from the written ones by {written_err:.3g} (tol 1e-4)")
        check(np.ptp(written) > 0 and np.isfinite(auc),
              f"import {name}: constant scores {written[:4]} (AUROC {auc})")
        lines.append(f"{name} evaluated by --load on {n} images (synthetic AUROC {auc:.4f}, "
                     f"scores {written.min():.4f}..{written.max():.4f}): features vs the "
                     f"source model's {err:.3g} of max, scores {score_err:.3g} (tol 1e-4); "
                     f"{len(keys)} tensors equal to the source's")
        del model, recorded, feats
        evaluated[name] = None
    torch.cuda.empty_cache()
    print(f"import: {'; '.join(lines)}; {seconds:.1f} s with the evaluations; launches "
          f"{counts} [{card}]")
    return counts


# ---------------------------------------------------------------- pool

POOL_SHAPE = (256, 64, 112, 112)      # the WRN stem's pool, NCHW


def phase_pool(card: str):
    """``ops.pool.max_pool_3x3_s2_p1`` (the JAX package's measured negative
    result, wired into no model) against ``F.max_pool2d`` on the WRN stem's
    shape, on ReLU-like inputs (ties at 0): forward equal, gradient equal
    but for the order of the (up to four) windows' sums: 1e-6 of its
    largest entry in fp32, one bf16 rounding (2^-8 relative) in bf16; the
    device time of each, forward and backward."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.pool import max_pool_3x3_s2_p1
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lines = []
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -8)):
        x = torch.randn(POOL_SHAPE, generator=g, device="cuda").relu().to(dtype)
        x = x.requires_grad_()
        y_ref = F.max_pool2d(x, 3, 2, 1)
        dy = torch.randn(y_ref.shape, generator=g, device="cuda").to(dtype)
        (dx_ref,) = torch.autograd.grad(y_ref, x, dy)
        y = max_pool_3x3_s2_p1(x)
        (dx,) = torch.autograd.grad(y, x, dy)
        check(torch.equal(y, y_ref), f"pool {dtype}: forward differs from F.max_pool2d")
        err = float((dx.float() - dx_ref.float()).abs().max() / dx_ref.float().abs().max())
        check(err <= tol, f"pool {dtype}: gradient differs from F.max_pool2d's by {err}")
        ms = time_ms(lambda: torch.autograd.grad(max_pool_3x3_s2_p1(x), x, dy), iters=5)
        ref_ms = time_ms(lambda: torch.autograd.grad(F.max_pool2d(x, 3, 2, 1), x, dy), iters=5)
        with torch.no_grad():
            fwd = time_ms(lambda: max_pool_3x3_s2_p1(x), iters=5)
            ref_fwd = time_ms(lambda: F.max_pool2d(x, 3, 2, 1), iters=5)
        lines.append(f"{str(dtype).replace('torch.', '')}: forward {fwd:.3f} ms vs "
                     f"F.max_pool2d {ref_fwd:.3f}, forward + gradient {ms:.3f} ms vs {ref_ms:.3f}, "
                     f"gradient err {err:.3g} of max (tol {tol:.3g})")
        del x, y, y_ref, dy, dx, dx_ref
        torch.cuda.empty_cache()
    print(f"pool max_pool_3x3_s2_p1 on {POOL_SHAPE}: {'; '.join(lines)} [{card}]")


# ---------------------------------------------------------------- phase dp

DP_RANKS = 2
DP_CLIP_EPOCHS = 4        # one step an epoch: 20 synthetic class-0 images in a half of 128
DP_TIMEOUT = 600          # seconds for each group of processes
DP_SCORE_TOL = 1e-4       # scores and AUROCs (PERF.md section 2), or a tie
DP_CONV_TOL = 1e-5        # CNN32 fp32: losses and parameters
DP_ARGV = {
    "a": ["-e", str(DP_CLIP_EPOCHS), "--classes", "0", "-it", "1"],
    "b": ["-e", "2", "--classes", "0", "-it", "1"],
    "c": ["-e", "2", "--classes", "0", "-it", "4", "--vmap-seeds"],
    "d": ["--ev-generation-pool", "2", "--ev-generations", "2", "--epochs", "1",
          "--classes", "0", "-it", "1", "--ev-mutation-pool", "10", "--ev-select-toursize", "2",
          "--ev-vmap"],
}


def _scalar_losses(run: str) -> list:
    return [v for _, v in _read_json(run, "scalars")["training_cls0_seed0_loss"]]


def _scores(run: str, it: int = 0) -> list:
    return [v for _, v in sorted((int(k), v) for k, v in
                                 _read_json(run, f"eval_cls0_it{it}_anomaly_scores").items())]


def dp_child(tmp: str, tag: str):
    """One process of phase dp: (a)-(d) through the runners' ``main`` on the
    card, each printed as a "DP {json}" line. A rank of the group when
    EOE_TPU_DISTRIBUTED=1 names it, one process otherwise. Its data and runs
    lie under ``<tmp>/<tag>``; (b)-(d) update with SGD (``_SgdTrainers``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
    from eoe_tpu_torch.main import evolve_oe_cifar, train_cifar, train_clip_cifar
    from eoe_tpu_torch.ops import attention as A
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.join(tmp, tag)
    trainers, step_ms, rows, chunks = [], [], Counter(), []
    launch, train_step, run = A._fwd_kernel, Trainer.train_step, Trainer.run
    evaluate = VmappedEvaluator.evaluate_population

    def recorded(qkv, heads, causal):   # image-tower launches by image count
        rows["text" if causal else str(qkv.shape[0])] += 1
        return launch(qkv, heads, causal)

    def timed_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def kept_run(self, *args, **kwargs):
        trainers.append(self)
        return run(self, *args, **kwargs)

    def sharded_population(self, individuals):   # whether the last chunk was split
        out = evaluate(self, individuals)
        chunks.append(self.trainer._last_vmap_sharded)
        return out

    def emit(case, **kw):
        print("DP " + json.dumps({"case": case, **kw}), flush=True)

    A._fwd_kernel, Trainer.train_step, Trainer.run = recorded, timed_step, kept_run
    VmappedEvaluator.evaluate_population = sharded_population
    # one process takes the per-step loop too, as the ranks do: step_ms
    # times each step and recorded counts each launch
    eager = _Eager()
    eager.__enter__()
    try:
        # (a) CLIP ViT-B/32 bf16 HSC, counted
        _zero_counts()
        train_clip_cifar.main(DP_ARGV["a"] + ["--datapath", root])
        counts = _counts()
        clip_run = _run_dirs(root, "log_*_clip_cifar10_one_vs_rest_E4")[0]
        ms_a, rows_a = list(step_ms), dict(rows)
        allreduce_ms, grad_bytes = None, 0
        if dist.is_initialized():   # a gloo all-reduce of the trained gradients' bytes
            tr = trainers[-1]
            grads = [p for p in tr.model.parameters() if p.requires_grad]
            grad_bytes = sum(p.numel() * p.element_size() for p in grads)
            buf = torch.zeros(sum(p.numel() for p in grads), dtype=grads[0].dtype,
                              device=tr.device)
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(buf, group=tr.mesh.group)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            allreduce_ms = float(np.median(times[1:]))
        emit("a", counts=counts, rows=rows_a, losses=list(trainers[-1].step_losses),
             scores=_scores(clip_run), auroc=_read_json(clip_run, "results")["eval_mean_auc"],
             step_ms=ms_a, allreduce_ms=allreduce_ms, grad_bytes=grad_bytes,
             mesh=trainers[-1].mesh.note if trainers[-1].mesh is not None else None)
        # (b)-(d) CNN32 fp32 with SGD
        with _SgdTrainers():
            _zero_counts()
            train_cifar.main(DP_ARGV["b"] + ["--datapath", root, "--superdir", "b"])
            conv_run = _run_dirs(root, "b/log_*")[0]
            emit("b", counts=_counts(), losses=list(trainers[-1].step_losses), run=conv_run,
                 scores=_scores(conv_run))
            _zero_counts()
            _, res = train_cifar.main(DP_ARGV["c"] + ["--datapath", root, "--superdir", "c"])
            grid_run = _run_dirs(root, "c/log_*")[0]
            emit("c", counts=_counts(), aucs=res["cls_aucs"][0],
                 sharded=trainers[-1]._last_vmap_sharded,
                 vmapped="vmapped" in _printed(grid_run),
                 scores=[_scores(grid_run, it) for it in range(4)])
            _zero_counts()
            history, _ = evolve_oe_cifar.main(DP_ARGV["d"] + ["--datapath", root,
                                                              "--superdir", root])
            emit("d", counts=_counts(), fits=history["fit"], pop=history["pop"],
                 sharded=chunks)
    finally:
        A._fwd_kernel, Trainer.train_step, Trainer.run = launch, train_step, run
        VmappedEvaluator.evaluate_population = evaluate
        eager.__exit__()
        meshlib.leave()


def _children(phase: str, tmp: str, tags: list, envs: list) -> list:
    """Run this script's ``--<phase>-child`` in one process per tag,
    together; each one's records, the JSON of its lines that begin with
    the phase's name in capitals. A process that fails fails the phase, its
    last lines printed."""
    script, marker = os.path.abspath(__file__), phase.upper() + " "
    procs = [subprocess.Popen([sys.executable, script, f"--{phase}-child", tmp, tag], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for tag, env in zip(tags, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        outs = [""] * len(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for tag, p, out in zip(tags, procs, outs):
        if p.returncode != 0:
            print("\n".join(out.splitlines()[-40:]), file=sys.stderr)
            fail(f"{phase}: process {tag} exited with {p.returncode}")
        records.append([json.loads(ln[len(marker):]) for ln in out.splitlines()
                        if ln.startswith(marker)])
    return records


def _dp_group(tmp: str, tags: list, envs: list) -> list:
    """``dp_child`` in one process per tag, together; their records by case."""
    records = [{r["case"]: r for r in got} for got in _children("dp", tmp, tags, envs)]
    for tag, got in zip(tags, records):
        check(sorted(got) == sorted(DP_ARGV), f"dp: {tag} reported {sorted(got)}")
    return records


def _tie_or_close(a: float, b: float, scores_a, scores_b) -> tuple:
    """(AUROC difference, score difference, held): within DP_SCORE_TOL, or
    AUROCs apart only through scores that are (a tie moved by float noise)."""
    import numpy as np
    d_auc = abs(a - b)
    d_score = float(np.abs(np.asarray(scores_a) - np.asarray(scores_b)).max())
    return d_auc, d_score, d_auc <= DP_SCORE_TOL or d_score <= DP_SCORE_TOL


def phase_dp(card: str) -> dict:
    """The data axis: one process, then two ranks on the one card
    (EOE_TPU_DISTRIBUTED=1, gloo), each through (a)-(d) of ``dp_child``. Each
    rank against the process: (a) ``train_clip_cifar`` ViT-B/32 bf16 HSC at
    128 + 128 (64 + 64 a rank), every step's loss within 2^-8, scores and
    AUROC 1e-4 or a tie, the fused kernels' launch counts equal, the image
    tower's launches on 128 and 64 rows instead of 256 and 128; (b)
    ``train_cifar`` CNN32 fp32: losses and parameters 1e-5; (c) 4 seeds
    ``--vmap-seeds``, 2 a rank: each seed's AUROC 1e-4 or a tie; (d)
    ``evolve_oe_cifar --ev-vmap``, one chunk of two candidates over the
    ranks: fitnesses 1e-4 or a tie, populations equal. The step ms per rank
    and a gloo all-reduce of the trained gradients' bytes are host clocks
    of processes that share the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32, to_openai
    from eoe_tpu_torch.parallel.mesh import free_port

    tmp = tempfile.mkdtemp(prefix="eoe_dp_")
    try:
        ckpt = os.path.join(tmp, "ViT-B-32.pt")
        weights = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
        torch.save(to_openai(weights, VIT_B32), ckpt)
        del weights
        base = {k: v for k, v in os.environ.items() if not k.startswith("EOE_TPU_")}
        base.update(EOE_TPU_FAKE_DATA="1", EOE_TPU_CLIP_CHECKPOINT=ckpt,
                    PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        one = _dp_group(tmp, ["one"], [base])[0]
        t_one = time.perf_counter() - t0
        addr = f"localhost:{free_port()}"
        envs = [dict(base, EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr,
                     EOE_TPU_NUM_PROCESSES=str(DP_RANKS), EOE_TPU_PROCESS_ID=str(i))
                for i in range(DP_RANKS)]
        t0 = time.perf_counter()
        ranks = _dp_group(tmp, [f"rank{i}" for i in range(DP_RANKS)], envs)
        t_ranks = time.perf_counter() - t0

        # (a)
        a1, layers = one["a"], VIT_B32.vision_layers
        check(a1["rows"] == {"text": VIT_B32.transformer_layers, str(2 * BATCH):
                             layers * DP_CLIP_EPOCHS, str(BATCH): layers},
              f"dp (a) one process: image-tower launches by rows {a1['rows']}")
        for i, r in enumerate(ranks):
            a = r["a"]
            check(a["counts"]["fwd"] == a1["counts"]["fwd"] and
                  a["counts"]["bwd"] == a1["counts"]["bwd"],
                  f"dp (a) rank {i}: launches {a['counts']} against one process's {a1['counts']}")
            check(a["rows"] == {"text": VIT_B32.transformer_layers, str(BATCH):
                                layers * DP_CLIP_EPOCHS, str(BATCH // DP_RANKS): layers},
                  f"dp (a) rank {i}: the kernels saw rows {a['rows']}, not the local batch")
            l_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], a1["losses"]))
            check(len(a["losses"]) == DP_CLIP_EPOCHS and l_err <= 2 ** -8,
                  f"dp (a) rank {i}: losses {a['losses']} against {a1['losses']} (tol 2^-8)")
            d_auc, d_score, held = _tie_or_close(a["auroc"], a1["auroc"], a["scores"],
                                                 a1["scores"])
            check(held, f"dp (a) rank {i}: AUROC {a['auroc']} against {a1['auroc']}, scores "
                        f"{d_score} apart (tol {DP_SCORE_TOL})")
        a0 = ranks[0]["a"]
        step_one = float(np.median(a1["step_ms"][1:]))
        step_ranks = [float(np.median(r["a"]["step_ms"][1:])) for r in ranks]
        share = a0["allreduce_ms"] / step_ranks[0]
        print(f"dp (a) train_clip_cifar ViT-B/32 bf16 HSC, {DP_CLIP_EPOCHS} steps of "
              f"{BATCH}+{BATCH}: {a0['mesh']}; step {step_one:.1f} ms in one process, "
              f"{[round(s, 1) for s in step_ranks]} ms per rank ({DP_RANKS} ranks on one "
              f"card, gloo through the host; medians of steps 2-{DP_CLIP_EPOCHS}); a gloo "
              f"all-reduce of the {a0['grad_bytes'] / 2 ** 20:.1f} MiB of trained gradients "
              f"{a0['allreduce_ms']:.1f} ms, {share:.1%} of rank 0's step; losses "
              f"{a0['losses']} vs {a1['losses']}; AUROC {a0['auroc']:.6f} vs "
              f"{a1['auroc']:.6f}, scores {d_score:.3g} apart; launches per rank "
              f"{a0['counts']}, image rows {a0['rows']} [{card}]")

        # (b)
        b1 = one["b"]
        p1 = torch.load(os.path.join(b1["run"], "snapshots", "snapshot_cls0_it0.pt"),
                        map_location="cpu", weights_only=True)["params"]
        for i, r in enumerate(ranks):
            b = r["b"]
            l_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], b1["losses"]))
            check(l_err <= DP_CONV_TOL, f"dp (b) rank {i}: losses {b['losses']} against "
                                        f"{b1['losses']} (tol {DP_CONV_TOL})")
        p0 = torch.load(os.path.join(ranks[0]["b"]["run"], "snapshots", "snapshot_cls0_it0.pt"),
                        map_location="cpu", weights_only=True)["params"]
        p_err = max(float((p0[k].float() - v.float()).abs().max()) for k, v in p1.items())
        check(p0.keys() == CNN32().state_dict().keys() and p_err <= DP_CONV_TOL,
              f"dp (b): parameters {p_err} from one process's (tol {DP_CONV_TOL})")
        print(f"dp (b) train_cifar CNN32 fp32: {len(b1['losses'])} steps, losses "
              f"{ranks[0]['b']['losses']} vs {b1['losses']}; parameters {p_err:.3g} apart "
              f"[{card}]")

        # (c)
        c1 = one["c"]
        check(c1["vmapped"] and not c1["sharded"], f"dp (c) one process: {c1}")
        for i, r in enumerate(ranks):
            c = r["c"]
            check(c["vmapped"] and c["sharded"], f"dp (c) rank {i}: the seeds did not shard")
            for k in range(4):
                d_auc, d_score, held = _tie_or_close(c["aucs"][k], c1["aucs"][k],
                                                     c["scores"][k], c1["scores"][k])
                check(held, f"dp (c) rank {i} seed {k}: AUROC {c['aucs'][k]} against "
                            f"{c1['aucs'][k]}, scores {d_score} apart")
        print(f"dp (c) train_cifar -it 4 --vmap-seeds, 2 seeds a rank: AUROCs "
              f"{ranks[0]['c']['aucs']} vs {c1['aucs']} [{card}]")

        # (d)
        d1 = one["d"]
        check(d1["sharded"] and not any(d1["sharded"]), f"dp (d) one process: {d1['sharded']}")
        for i, r in enumerate(ranks):
            d = r["d"]
            check(d["sharded"][:1] == [True], f"dp (d) rank {i}: generation 0's chunk of two "
                                              f"did not split over the ranks: {d['sharded']}")
            check(d["pop"] == d1["pop"], f"dp (d) rank {i}: populations {d['pop']} against "
                                         f"{d1['pop']}")
            f_err = float(np.abs(np.asarray(d["fits"]) - np.asarray(d1["fits"])).max())
            check(f_err <= DP_SCORE_TOL, f"dp (d) rank {i}: fitnesses {d['fits']} against "
                                         f"{d1['fits']}")
        print(f"dp (d) evolve_oe_cifar --ev-vmap, pool 2 over {DP_RANKS} ranks, 2 "
              f"generations: fitnesses {ranks[0]['d']['fits']} vs {d1['fits']}, populations "
              f"equal [{card}]")
        print(f"dp: one process {t_one:.1f} s, {DP_RANKS} ranks {t_ranks:.1f} s [{card}]")
        return {**{f"dp_clip_rank{i}": r["a"]["counts"] for i, r in enumerate(ranks)},
                "dp_conv": ranks[0]["b"]["counts"], "dp_vmap": ranks[0]["c"]["counts"],
                "dp_evolve": ranks[0]["d"]["counts"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase tp

TP_RANKS = 2
TP_N, TP_TEST = 3 * BATCH, BATCH   # 3 steps of 128 + 128, one eval batch
TP_DTYPES = ("fp32", "bf16")
TP_FP32_TOL = 1e-5        # fp32: losses (relative) and parameters
TP_LOSS_TOL = 2 ** -8     # bf16 losses (BF16_LOSS_TOL)
# bf16: the split sums in another order than one process's, and bf16 turns
# an order flip into a rounding flip that grows through the layers and the
# steps. So the ranks' trained parameters and scores are held by their
# distance from one process's fp32 run: at most twice one process's bf16
# distance from it (two realisations of the same rounding noise). A
# missing sum or a wrong split moves them by order 1; the fp32 run holds
# the arithmetic itself to TP_FP32_TOL.
TP_BF16_FACTOR = 2.0


def _tp_data():
    """384 normal + 384 OE + 128 test raw 256x256 uint8 images (the
    acceptance stack's input size)."""
    import numpy as np
    from eoe_tpu_torch.datasets.bases import ArraySource, CombinedDataset, GenericADDataset
    rng, hw = np.random.default_rng(SEED + 7), TRAIN_HW
    x, xo, xt = (rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
                 for n in (TP_N, TP_N, TP_TEST))
    kw = dict(root="", train_specs=ACCEPTANCE_SPECS, test_specs=CLIP_TEST_SPECS, n_classes=2,
              raw_shape=(hw, hw, 3))
    normal = GenericADDataset(ArraySource(x, np.zeros(TP_N)),
                              ArraySource(xt, np.arange(TP_TEST) % 2),
                              normal_classes=(0,), nominal_label=0, **kw)
    oe = GenericADDataset(ArraySource(xo, np.ones(TP_N)), None, normal_classes=(1,),
                          nominal_label=1, **kw)
    return CombinedDataset(normal, oe)


def tp_child(tmp: str, tag: str):
    """One rank of phase tp (EOE_TPU_DISTRIBUTED=1 names it) on a 1 x 2 mesh,
    the model axis: ``_tp_runs``, printed as one "TP {json}" line."""
    import torch
    from eoe_tpu_torch.parallel import mesh as meshlib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshlib.init_distributed()
    try:
        record = _tp_runs(tmp, tag, meshlib.make_mesh(meshlib.MeshConfig(data=1, model=TP_RANKS)))
        print("TP " + json.dumps(record), flush=True)
    finally:
        meshlib.leave()


def _tp_runs(tmp: str, tag: str, mesh) -> dict:
    """``ClipTrainer.run`` of ViT-B/32 from seed 0's weights on ``_tp_data``,
    3 steps on the per-step loop and one eval batch, in fp32 and then in
    bf16, each counted and traced (paths ``tp_<tag>_fp32`` and
    ``tp_<tag>``), on ``mesh`` or in this process (None). By dtype: the
    launch counts, the fused kernels' calls by heads and rows, losses, step
    ms, scores, the run directory."""
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops import attention as A
    from eoe_tpu_torch.training import Trainer
    from eoe_tpu_torch.training.clip import ClipTrainer
    from eoe_tpu_torch.utils.logger import Logger

    calls, step_ms = Counter(), []
    fwd, bwd, train_step = A._fwd_kernel, A._bwd_kernel, Trainer.train_step

    def tally(kind, launch):
        def recorded(qkv, *args):
            heads, causal = args[-2:]
            calls[f"{kind} H={heads} n={qkv.shape[0]}{' causal' if causal else ''}"] += 1
            return launch(qkv, *args)
        return recorded

    def timed_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    A._fwd_kernel, A._bwd_kernel = tally("fwd", fwd), tally("bwd", bwd)
    Trainer.train_step = timed_step
    eager = _Eager()
    eager.__enter__()
    try:
        weights = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
        ds = _tp_data()
        record = {"case": tag, "mesh": None if mesh is None else mesh.note}
        for name in TP_DTYPES:
            calls.clear()
            step_ms.clear()
            logdir = os.path.join(tmp, f"{tag}_{name}")
            logger = Logger(logdir, noname=True, active=mesh is None or mesh.model_rank == 0,
                            tensorboard=False, archive_source=False)
            tr = ClipTrainer(None, ACCEPTANCE_SPECS, [], dataset="cifar10",
                             oe_dataset="cifar100", datapath="", logger=logger, epochs=1,
                             lr=1e-4, wdk=1e-3, milestones=[], batch_size=BATCH,
                             compute_dtype=torch.bfloat16 if name == "bf16" else torch.float32,
                             mesh=mesh, clip_state_dict=weights, clip_config=VIT_B32)
            tr.ds = ds
            path = f"tp_{tag}" + ("" if name == "bf16" else f"_{name}")
            _zero_counts(path)
            t0 = time.perf_counter()
            _, res = tr.run(run_classes=[0])
            seconds = time.perf_counter() - t0
            counts = _counts()
            record[name] = {
                "path": path, "counts": counts, "calls": dict(calls),
                "losses": list(tr.step_losses), "step_ms": list(step_ms), "seconds": seconds,
                "auroc": res["cls_aucs"][0][0], "traced": TRACED[path], "logdir": logdir,
                "scores": _scores(logdir) if logger.active else None,
                "held": None if tr._tp is None or tr._tp[1] is None else
                sum(p.numel() for p in tr._tp[1].parameters())}
            del tr
            torch.cuda.empty_cache()
        return record
    finally:
        A._fwd_kernel, A._bwd_kernel, Trainer.train_step = fwd, bwd, train_step
        eager.__exit__()


def _tp_group(tmp: str, tags: list, envs: list) -> list:
    """``tp_child`` in one process per tag, together; their records."""
    records = _children("tp", tmp, tags, envs)
    for tag, got in zip(tags, records):
        check(len(got) == 1, f"tp: {tag} reported {len(got)} records")
    return [got[0] for got in records]


def _tp_params(logdir: str) -> dict:
    import torch
    return torch.load(os.path.join(logdir, "snapshots", "snapshot_cls0_it0.pt"),
                      map_location="cpu", weights_only=True)["params"]


def _param_err(p: dict, ref: dict, p_init: dict) -> float:
    """The largest distance of a trained tensor of ``p`` from ``ref``'s, of
    ``ref``'s change from ``p_init``."""
    return max(float((p[k].float() - v.float()).abs().max()
                     / (v.float() - p_init[k]).abs().max())
               for k, v in ref.items() if (v.float() - p_init[k]).abs().max())


def _tp_hold(name: str, one: dict, got: list, p_init: dict, one32: dict) -> str:
    """One dtype's holds of the ranks against one process (``phase_tp``);
    bf16 also against one process's fp32 run ``one32``. Returns what was
    held, for the phase's line."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import VIT_B32
    layers, text, steps = VIT_B32.vision_layers, VIT_B32.transformer_layers, TP_N // BATCH

    def calls(h, ht):
        return {f"fwd H={ht} n=2 causal": text, f"fwd H={h} n={2 * BATCH}": layers * steps,
                f"fwd H={h} n={TP_TEST}": layers, f"bwd H={h} n={2 * BATCH}": layers * steps}

    expected = {"fwd": text + layers * (steps + 1), "bwd": layers * steps,
                **augment_counts(2 * steps + PREVIEW_CALLS, stats=True)}
    if name == "fp32":
        expected["bwd_resident"] = layers * steps
    check(one["calls"] == calls(VIT_B32.vision_heads, VIT_B32.transformer_heads),
          f"tp {name} one process: fused calls {one['calls']}")
    check_counts(one["counts"], expected, f"tp {name} one process")
    h, ht = VIT_B32.vision_heads // TP_RANKS, VIT_B32.transformer_heads // TP_RANKS
    l_tol = TP_LOSS_TOL if name == "bf16" else TP_FP32_TOL
    for i, r in enumerate(got):
        check(r["calls"] == calls(h, ht), f"tp {name} rank {i}: fused calls {r['calls']}")
        # the preview is written where the logger writes: world rank 0
        check_counts(r["counts"], {**expected, **augment_counts(
            2 * steps + (PREVIEW_CALLS if r["scores"] is not None else 0), stats=True)},
            f"tp {name} rank {i}")
        check(len(r["losses"]) == steps and r["losses"] == got[0]["losses"],
              f"tp {name} rank {i}: losses {r['losses']}, rank 0's {got[0]['losses']}")
        l_err = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], one["losses"]))
        check(l_err <= l_tol, f"tp {name} rank {i}: losses {r['losses']} against one "
                              f"process's {one['losses']} (tol {l_tol:.3g})")
    p_one, p_tp = _tp_params(one["logdir"]), _tp_params(got[0]["logdir"])
    check(p_tp.keys() == p_one.keys() and all(p_tp[k].shape == v.shape for k, v in p_one.items()),
          f"tp {name}: the snapshot is not whole")
    for k, v in p_one.items():   # the untrained text tower: equal, bit for bit
        if not (v.float() - p_init[k]).abs().max():
            check(torch.equal(p_tp[k], v), f"tp {name}: the untrained {k} differs")
    r0 = got[0]
    d_auc, d_score, held = _tie_or_close(r0["auroc"], one["auroc"], r0["scores"], one["scores"])
    if name == "fp32":
        p_err = max(float((p_tp[k] - v).abs().max()) for k, v in p_one.items())
        check(p_err <= TP_FP32_TOL, f"tp fp32: parameters {p_err:.3g} apart (tol "
                                    f"{TP_FP32_TOL})")
        check(held, f"tp fp32: AUROC {r0['auroc']} against {one['auroc']}, scores {d_score} "
                    f"apart (tol {DP_SCORE_TOL})")
        return (f"losses {l_err:.3g} apart, parameters {p_err:.3g}, scores {d_score:.3g}, "
                f"AUROC {r0['auroc']:.6f} vs {one['auroc']:.6f}")
    p32 = _tp_params(one32["logdir"])
    e_tp, e_one = _param_err(p_tp, p32, p_init), _param_err(p_one, p32, p_init)
    s32 = np.asarray(one32["scores"])
    s_tp = float(np.abs(np.asarray(r0["scores"]) - s32).max())
    s_one = float(np.abs(np.asarray(one["scores"]) - s32).max())
    check(e_tp <= TP_BF16_FACTOR * e_one,
          f"tp bf16: trained parameters {e_tp:.3g} of their fp32 change from one process's "
          f"fp32 run, one process's bf16 {e_one:.3g} (at most {TP_BF16_FACTOR}x)")
    check(s_tp <= TP_BF16_FACTOR * s_one,
          f"tp bf16: scores {s_tp:.3g} from one process's fp32 run, one process's bf16 "
          f"{s_one:.3g} (at most {TP_BF16_FACTOR}x)")
    return (f"losses {l_err:.3g} apart; from one process's fp32 run, trained parameters "
            f"{e_tp:.3g} of their change (one process's bf16 {e_one:.3g}), scores {s_tp:.3g} "
            f"({s_one:.3g}); ranks and process {_param_err(p_tp, p_one, p_init):.3g} and "
            f"{d_score:.3g} apart, AUROC {r0['auroc']:.6f} vs {one['auroc']:.6f} (fp32 "
            f"{one32['auroc']:.6f})")


def phase_tp(card: str) -> dict:
    """The model axis: ``ClipTrainer.run`` of ViT-B/32 (3 steps of 128 +
    128 on the acceptance stack, one eval batch of 128) in this process,
    then on a 1 x 2 mesh of two ranks sharing the one card over gloo
    (``tp_child``), in fp32 and in bf16 (``_tp_runs``). Each rank: the fused forward and
    backward on its 6 of the 12 image heads and 4 of the 8 causal text heads
    (the prompt centre), as many launches as one process's, equal to its
    trace. fp32: losses and the snapshot's parameters (world rank 0's,
    gathered whole) within ``TP_FP32_TOL`` of the process's, scores and
    AUROC 1e-4 or a tie. bf16: losses within ``TP_LOSS_TOL``; trained
    parameters and scores no further from the process's fp32 run than
    ``TP_BF16_FACTOR`` times the process's bf16 run. The untrained text
    tower equal bit for bit. On two or more cards the ranks run again over
    NCCL, a card each."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.parallel.mesh import free_port

    tmp = tempfile.mkdtemp(prefix="eoe_tp_")
    try:
        base = {k: v for k, v in os.environ.items() if not k.startswith("EOE_TPU_")}
        base.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))

        def ranks(tags):
            addr = f"localhost:{free_port()}"
            return [dict(base, EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr,
                         EOE_TPU_NUM_PROCESSES=str(TP_RANKS), EOE_TPU_PROCESS_ID=str(i))
                    for i in range(len(tags))]

        t0 = time.perf_counter()
        one = _tp_runs(tmp, "one", None)
        t_one = time.perf_counter() - t0
        tags = [f"rank{i}" for i in range(TP_RANKS)]
        t0 = time.perf_counter()
        got = _tp_group(tmp, tags, ranks(tags))
        t_ranks = time.perf_counter() - t0
        p_init = CLIP(VIT_B32, generator=torch.Generator().manual_seed(SEED)).state_dict()
        steps = TP_N // BATCH
        for name in TP_DTYPES:
            held = _tp_hold(name, one[name], [r[name] for r in got], p_init, one["fp32"])
            TRACED.update({r[name]["path"]: r[name]["traced"] for r in got})
            r0, o = got[0][name], one[name]
            step_one = float(np.median(o["step_ms"][1:]))
            step_ranks = [float(np.median(r[name]["step_ms"][1:])) for r in got]
            print(f"tp {name} ClipTrainer.run ViT-B/32, {steps} steps of {BATCH}+{BATCH}: "
                  f"{got[0]['mesh']}; each rank holds {r0['held']:,} parameters of the "
                  f"model's copy; fused calls per rank {r0['calls']}; step {step_one:.1f} ms in "
                  f"one process, {[round(x, 1) for x in step_ranks]} ms per rank ({TP_RANKS} "
                  f"ranks on one card, gloo through the host; traced runs, medians of steps "
                  f"2-{steps}); losses {r0['losses']} vs {o['losses']}; {held}; launches per "
                  f"rank {r0['counts']}; run {r0['seconds']:.1f} s vs {o['seconds']:.1f} s "
                  f"[{card}]")
        print(f"tp: one process {t_one:.1f} s, {TP_RANKS} ranks {t_ranks:.1f} s [{card}]")
        cards = torch.cuda.device_count()
        if cards >= TP_RANKS:   # NCCL, a card a rank
            tags = [f"nccl{i}" for i in range(TP_RANKS)]
            nccl = _tp_group(tmp, tags, ranks(tags))
            check("collectives on nccl" in nccl[0]["mesh"], f"tp: {nccl[0]['mesh']}")
            for name in TP_DTYPES:
                _tp_hold(name, one[name], [r[name] for r in nccl], p_init, one["fp32"])
                step = [float(np.median(r[name]["step_ms"][1:])) for r in nccl]
                print(f"tp {name} over NCCL, a card a rank: step {[round(x, 1) for x in step]} "
                      f"ms per rank against {float(np.median(one[name]['step_ms'][1:])):.1f} "
                      f"ms in one process on one card; {nccl[0]['mesh']} [{card}]")
        else:
            print(f"tp over NCCL: not run ({cards} card; it needs {TP_RANKS})")
        return {r[name]["path"]: r[name]["counts"] for r in [one, *got] for name in TP_DTYPES}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase dp_graph

DPG_RANKS = 2
DPG_FP32_TOL = 1e-5          # fp32 losses (relative) and parameters
DPG_BF16_TOL = 2 ** -8       # bf16 losses (relative)
DPG_SEEDS = 3                # a grid that two ranks do not divide: 2 + 1
DPG_VIT_STEPS, DPG_CONV_STEPS = 4, 8      # an epoch's steps of 256 + 256 (128 + 128 a rank)
DPG_EPOCHS = 2
DPG_CONV_MILESTONES = [1]    # (c)'s CNN32: a new rate in epoch 2, captured again on both ranks
DPG_GRID_N, DPG_GRID_EPOCHS = 4 * BATCH, 2
# tests/test_parallel.py's tiny CLIP: heads that a model axis of two divides
DPG_TINY = dict(embed_dim=32, image_resolution=16, vision_layers=1, vision_width=64,
                vision_patch_size=8, context_length=16, vocab_size=64, transformer_width=32,
                transformer_heads=2, transformer_layers=1, vision_heads_override=2)
DPG_TINY_SPECS = [{"op": "random_hflip"}, {"op": "clip_pil_preprocessing", "resolution": 16},
                  {"op": "clip_tensor_preprocessing"}]
DPG_TINY_B, DPG_TINY_N = 16, 64


class _Collectives:
    """Within: every ``torch.distributed.all_reduce`` on an NCCL group
    counted: those of eager code (``eager``), those of an eager step of
    each runner (``steps``: {runner: calls}) and those each capture records,
    a milestone's capture again included (``captures``: [runner, calls,
    the runner's replays before it]). A trace of the run should show
    ``expected()`` NCCL kernels: one a call, a graph's once a replay."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from eoe_tpu_torch.training import graphs
        self.eager, self.steps, self.captures = 0, {}, []
        self.saved = dist.all_reduce, graphs.ResidentSteps._eager, graphs.ResidentSteps._capture
        all_reduce, eager, capture = self.saved
        me = self

        def counted(tensor, *args, group=None, **kwargs):
            if dist.get_backend(group) == "nccl":
                if torch.cuda.is_current_stream_capturing():
                    me.captures[-1][1] += 1
                else:
                    me.eager += 1
            return all_reduce(tensor, *args, group=group, **kwargs)

        def first(runner, n):
            before = me.eager
            eager(runner, n)
            me.steps[runner] = (me.eager - before) // n

        def recorded(runner, rates):
            me.captures.append([runner, 0, runner.replays])
            capture(runner, rates)

        dist.all_reduce, graphs.ResidentSteps._eager = counted, first
        graphs.ResidentSteps._capture = recorded
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        from eoe_tpu_torch.training import graphs
        dist.all_reduce, graphs.ResidentSteps._eager, graphs.ResidentSteps._capture = self.saved

    def graphs(self) -> list:
        """[calls of an eager step of its runner, calls recorded] a capture."""
        return [[self.steps.get(runner), calls] for runner, calls, _ in self.captures]

    def expected(self) -> int:
        total = self.eager
        for i, (runner, calls, start) in enumerate(self.captures):
            end = next((s for r, _, s in self.captures[i + 1:] if r is runner), runner.replays)
            total += calls * (end - start)
        return total


class _Uncaptured:
    """Within: ``graphs.ResidentSteps`` runs its steps as they are, eagerly
    on the current stream, over the same buffers and counter (the CPU's way
    on the card): the eager control of a captured step."""

    def __enter__(self):
        from eoe_tpu_torch.training import graphs
        self.saved = graphs.ResidentSteps.__init__

        def init(runner, *args, **kwargs):
            self.saved(runner, *args, **kwargs)
            runner.captured = False

        graphs.ResidentSteps.__init__ = init

    def __exit__(self, *exc):
        from eoe_tpu_torch.training import graphs
        graphs.ResidentSteps.__init__ = self.saved


def _dpg_train(tr, ds, per_step: bool, trace: str = None) -> dict:
    """``train_cls`` of class 0, seed 0 through the resident epoch or the
    per-step loop (``per_step``), then the test scores: its losses, the
    last epoch's ms a step (global images a step over the epoch's img/s),
    scores, AUROC, the full parameters (gathered over a model axis) and the
    launch counts. With ``trace`` (a path) under ``torch.profiler``: the
    port's kernels in the trace held against the counters, the NCCL kernels
    against the collectives' calls (``_Collectives``)."""
    import numpy as np
    import torch
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import graphs
    tr._per_step = per_step
    tr.step_losses, tr.epoch_rates = [], []
    runners, init = [], graphs.ResidentSteps.__init__

    def kept(runner, *args, **kwargs):
        init(runner, *args, **kwargs)
        runners.append(runner)

    graphs.ResidentSteps.__init__ = kept
    try:
        with _Collectives() as calls:
            prof = _trace_start() if trace else None
            _zero_counts()
            state, _ = tr.train_cls(ds, 0, "airplane", 0, seed=SEED)
            torch.cuda.synchronize()
            counts = _counts()
            if prof is not None:
                _trace_stop(prof)
    finally:
        graphs.ResidentSteps.__init__ = init
    record = {"losses": list(tr.step_losses), "counts": counts,
              "step_ms": 1e3 * 2 * tr.batch_size / tr.epoch_rates[-1],
              "captured": sum(r.captures for r in runners if r.captured),
              "replays": sum(r.replays for r in runners if r.captured),
              "collectives": {"eager": calls.eager, "graphs": calls.graphs()}}
    if prof is not None:
        record["traced"] = hold_traced(prof, counts, f"dp_graph {trace}", trace)
        nccl = [n for n in device_event_names(prof) if "nccl" in n.lower()]
        record["nccl"] = {"traced": len(nccl), "counted": calls.expected(),
                          "kernels": sorted({n[:90] for n in nccl})}
    scores = tr.eval_scores(state, ds)
    roc, _ = tr.eval_cls(state, ds, 0, "airplane", 1, scores=scores)
    params, shardings = state.model.state_dict(), tr._shardings(state)
    if shardings is not None:
        params = meshlib.gather_params(tr.mesh, params, shardings)
    record.update(scores=np.asarray(scores, np.float64).tolist(), auroc=roc.auc,
                  params={k: v.detach().float().cpu().clone() for k, v in params.items()})
    return record


def _dpg_conv(mesh, batch: int, n: int, epochs: int, milestones=()):
    """CNN32 fp32 HSC with SGD on CIFAR_SPECS, ``n`` + ``n`` raw 32x32
    images, the learning rate cut tenfold at each epoch of ``milestones``,
    and its data."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.training.optim import make_optimizer
    ds, _ = _pinned(np.random.default_rng(SEED), 32, n, 2 * BATCH, CIFAR_SPECS, ["normalize"])
    tr = TRAINER["hsc"](model=CNN32(), train_specs=CIFAR_SPECS, test_specs=["normalize"],
                        dataset="cifar10", oe_dataset="cifar100", datapath="", logger=None,
                        epochs=epochs, lr=1e-4, wdk=1e-3, milestones=list(milestones),
                        batch_size=batch, compute_dtype=torch.float32, mesh=mesh)
    tr.make_optimizer = lambda params, steps: make_optimizer("sgd", params, 1e-4, 1e-3,
                                                             list(milestones), steps)
    tr.ds = ds
    return tr, ds


def _dpg_vit(mesh):
    """ViT-B/32 bf16 HSC (SGD, the CLIP default) on the acceptance stack at
    256 + 256 a step (128 + 128 a rank of two), and its data."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.training import TRAINER
    n = DPG_VIT_STEPS * 2 * BATCH
    ds, _ = _pinned(np.random.default_rng(SEED), TRAIN_HW, n, 2 * BATCH, ACCEPTANCE_SPECS,
                    CLIP_TEST_SPECS)
    tr = TRAINER["hsc"](model=CLIP(VIT_B32, dtype=torch.bfloat16), train_specs=ACCEPTANCE_SPECS,
                        test_specs=CLIP_TEST_SPECS, dataset="cifar10", oe_dataset="cifar100",
                        datapath="", logger=None, epochs=DPG_EPOCHS, lr=1e-4, wdk=1e-3,
                        milestones=[], batch_size=2 * BATCH, compute_dtype=torch.bfloat16,
                        mesh=mesh)
    tr.ds = ds
    return tr, ds


def _dpg_tiny(mesh) -> dict:
    """The tiny CLIP in fp32 (HSC, SGD, a random flip), 2 epochs of 4 steps
    of 16 + 16, on the resident path: losses and the full parameters."""
    import numpy as np
    import torch
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.training import Trainer
    ds, _ = _pinned(np.random.default_rng(SEED), 16, DPG_TINY_N, DPG_TINY_B, DPG_TINY_SPECS,
                    DPG_TINY_SPECS[1:])
    cfg = ClipConfig(**DPG_TINY)
    weights = CLIP(cfg, generator=torch.Generator().manual_seed(SEED)).state_dict()
    tr = Trainer(model=CLIP(cfg), objective="hsc", train_specs=DPG_TINY_SPECS,
                 test_specs=DPG_TINY_SPECS[1:], dataset="cifar10", oe_dataset="cifar100",
                 datapath="", logger=None, epochs=DPG_EPOCHS, lr=1e-3, wdk=0.0, milestones=[],
                 batch_size=DPG_TINY_B, mesh=mesh)
    tr.init_weights = lambda seed: tr.model.load_state_dict(weights)
    out = _dpg_train(tr, ds, False)
    return {k: out[k] for k in ("losses", "params", "captured", "replays")}


def _dpg_grid(tmp: str, tag: str, mesh, trace: str = None) -> dict:
    """``Trainer.run`` of CNN32 fp32 with SGD, ``DPG_SEEDS`` seeds vmapped on
    the pinned CIFAR stack: each seed's AUROC and test scores, the losses,
    the members of each stacked program and how many graphs they
    captured. With ``trace`` (a path) under ``torch.profiler``: the port's
    kernels in the trace, the replays' included, held against the
    counters."""
    import torch
    from eoe_tpu_torch.training import graphs
    from eoe_tpu_torch.training import vmapped_seeds as V
    from eoe_tpu_torch.utils.logger import Logger
    logdir = os.path.join(tmp, f"grid_{tag}")
    tr, _ = _dpg_conv(mesh, BATCH, DPG_GRID_N, DPG_GRID_EPOCHS)
    tr.logger = Logger(logdir, noname=True, tensorboard=False, archive_source=False)
    stacks, members = [], V._train_members   # the programs' members (not the memory probe's)
    runners, init = [], graphs.ResidentSteps.__init__

    def kept(runner, *args, **kwargs):
        init(runner, *args, **kwargs)
        runners.append(runner)

    def program(trainer, ds, clsstr, seeds, first):
        stacks.append(len(seeds))
        return members(trainer, ds, clsstr, seeds, first)

    graphs.ResidentSteps.__init__, V._train_members = kept, program
    try:
        prof = _trace_start() if trace else None
        _zero_counts()
        _, res = tr.run(run_classes=[0], run_seeds=DPG_SEEDS, vmap_seeds=True)
        torch.cuda.synchronize()
        counts = _counts()
        if prof is not None:
            _trace_stop(prof)
    finally:
        graphs.ResidentSteps.__init__, V._train_members = init, members
    tr.logger.drain()
    record = {"aucs": res["cls_aucs"][0], "losses": list(tr.step_losses), "stacks": stacks,
              "captures": [r.captures for r in runners], "sharded": tr._last_vmap_sharded,
              "vmapped": tr._last_grid_vmapped, "counts": counts,
              "scores": [_scores(logdir, it) for it in range(DPG_SEEDS)]}
    if prof is not None:
        record["traced"] = hold_traced(prof, counts, f"dp_graph {trace}", trace)
    return record


def _own_grads(params, mesh):
    """A faulty gradient sum: each rank keeps its own share (DDP's 1 / data
    and no all-reduce), the control that shows (c)'s holds fail one."""
    for p in params:
        if p.grad is not None:
            p.grad.mul_(1.0 / mesh.data)


def _dpg_capture() -> dict:
    """One CNN32 fp32 step of 128 + 128 (SGD, CIFAR_SPECS) of the data-parallel
    code on a one-rank NCCL group: a mesh of data 2 whose group holds this
    rank alone, so that every collective of a rank of two (the weights'
    total, batch norm's sums forward and backward, the gradient sum) runs on
    an NCCL communicator of one rank, whose sum is its input. On one
    trainer: three steps (an eager first step, then one captured and
    replayed twice), traced; the per-step loop with DDP; the three steps
    captured again (DDP's wrapper, which holds the parameters' gradient
    accumulators, dropped first); the three steps uncaptured
    (``_Uncaptured``)."""
    import torch
    import torch.distributed as dist
    from eoe_tpu_torch.parallel import mesh as meshlib
    meshlib._init_group(f"localhost:{meshlib.free_port()}", 1, 0)
    try:
        dev = torch.device("cuda", 0)
        mesh = meshlib.Mesh(dist.new_group([0], backend="nccl"), "nccl", 0, 2, dev,
                            note="one rank of a data mesh of two, on a one-rank NCCL group")
        tr, ds = _dpg_conv(mesh, BATCH, 3 * BATCH, 1)
        out = {"graph": _dpg_train(tr, ds, False, "dp_graph_capture"),
               "ddp": _dpg_train(tr, ds, True), "graph_after_ddp": _dpg_train(tr, ds, False)}
        with _Uncaptured():
            out["eager"] = _dpg_train(tr, ds, False)
        return out
    finally:
        meshlib.leave()


def dpg_child(tmp: str, tag: str):
    """One process of phase dp_graph, ``tag`` = "<case>-<label>": capture
    (``_dpg_capture``), grid (``_dpg_grid``, a rank of two sharing the
    card), nccl (a rank of two on its own card: ViT-B/32 and CNN32 on the
    graph path, traced, and on the per-step loop; the tiny CLIP on a 2 x 1
    mesh) or tiny22 (a rank of a 2 x 2 mesh of four cards). Printed as one
    "DPG {json}" line; tensors under ``<tmp>/<tag>.pt``."""
    import torch
    from eoe_tpu_torch.parallel import mesh as meshlib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    case = tag.split("-")[0]
    if case == "capture":
        record = _dpg_capture()
    else:
        meshlib.init_distributed()
        try:
            if case == "grid":
                record = _dpg_grid(tmp, tag, meshlib.make_mesh(meshlib.MeshConfig(data=DPG_RANKS)),
                                   "dp_graph_grid_" + tag.split("-")[1])
            elif case == "tiny22":
                record = {"tiny22": _dpg_tiny(meshlib.make_mesh(
                    meshlib.MeshConfig(data=2, model=2)))}
            else:
                mesh = meshlib.make_mesh(meshlib.MeshConfig(data=DPG_RANKS))
                record = {"mesh": mesh.note, "tiny21": _dpg_tiny(mesh)}
                for name, build in (("cnn", _dpg_conv), ("vit", _dpg_vit)):
                    tr, ds = build(mesh) if name == "vit" else build(
                        mesh, 2 * BATCH, DPG_CONV_STEPS * 2 * BATCH, DPG_EPOCHS,
                        DPG_CONV_MILESTONES)
                    record[name] = {
                        "graph": _dpg_train(tr, ds, False, f"dp_graph_{name}_{tag}"),
                        "eager": _dpg_train(tr, ds, True),
                        "graph_untraced": _dpg_train(tr, ds, False)}
                    if name == "cnn":
                        summed, meshlib.all_reduce_grads = meshlib.all_reduce_grads, _own_grads
                        try:
                            record[name]["own_grads"] = _dpg_train(tr, ds, False)
                        finally:
                            meshlib.all_reduce_grads = summed
                    del tr, ds
                    torch.cuda.empty_cache()
        finally:
            meshlib.leave()
    torch.save(record, os.path.join(tmp, f"{tag}.pt"))
    print("DPG " + json.dumps({"case": tag}), flush=True)


def _dpg_group(tmp: str, tags: list, envs: list) -> list:
    """``dpg_child`` in one process per tag, together; their records."""
    import torch
    _children("dpg", tmp, tags, envs)
    return [torch.load(os.path.join(tmp, f"{tag}.pt"), weights_only=False) for tag in tags]


def _dpg_err(a: dict, b: dict) -> float:
    return max(float((a[k] - v).abs().max()) for k, v in b.items())


def _dpg_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_dp_graph(card: str) -> dict:
    """The resident epoch under a mesh (``training.graphs``, NCCL steps as
    CUDA graphs) and the seed grid split unevenly over the ranks. One card:
    (a) one CNN32 fp32 step of the data-parallel code captured on a one-rank
    NCCL group (``_dpg_capture``): its collectives recorded in the graph,
    three steps bit for bit the uncaptured steps' with SGD and the steps
    captured again on the trainer after a per-step run with DDP, the port's
    kernels in the trace equal to the counters, and the NCCL kernels the
    trace shows (a one-rank sum in place launches none); (b) two gloo ranks
    sharing the card on a grid of 3 CNN32 seeds (``_dpg_grid``): 2 + 1
    members, each rank's programs captured as graphs, every seed's AUROC
    1e-4 or a tie and the losses 1e-5 of one process's, each rank's run
    traced. Two or more cards: (c) two NCCL ranks, a card each, CNN32 fp32
    (batch norm's global sums; a milestone between its epochs, so that
    both ranks capture their step again) and ViT-B/32 bf16 at 128 + 128 a
    rank, each on the graph path, traced, and on the per-step loop: graph
    against per-step losses 1e-5 and parameters 1e-5 in fp32, losses 2^-8
    in bf16; ranks against one process at phase dp's holds; every capture's
    NCCL collectives those of an eager step, and the NCCL, fused and
    augmentation kernels of each rank's trace equal to the counts; CNN32
    trained with each rank's own gradients in the sum's place fails the
    hold against one process (the control); a rank's step ms both ways; (d) the
    tiny CLIP on a 2 x 1 mesh and, on four cards, a 2 x 2 mesh on the graph
    path against one process (losses and parameters 1e-5). The parameters of
    (c)'s CNN32 are held to one process's as phase resident holds CNN32's
    state, each tensor over max(1, |max|). The holds of (c) and (d) are all
    made before the phase fails on any of them."""
    import shutil
    import tempfile

    import torch
    from eoe_tpu_torch.parallel.mesh import free_port

    tmp = tempfile.mkdtemp(prefix="eoe_dpg_")
    try:
        base = {k: v for k, v in os.environ.items() if not k.startswith("EOE_TPU_")}
        base.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))

        def ranks(tags):
            addr = f"localhost:{free_port()}"
            return [dict(base, EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr,
                         EOE_TPU_NUM_PROCESSES=str(len(tags)), EOE_TPU_PROCESS_ID=str(i))
                    for i in range(len(tags))]

        cards, ran, paths = torch.cuda.device_count(), [], {}
        # (a)
        cap = _dpg_group(tmp, ["capture"], [base])[0]
        g, e, g2 = cap["graph"], cap["eager"], cap["graph_after_ddp"]
        steps = [s for s, _ in g["collectives"]["graphs"]]
        recorded = [r for _, r in g["collectives"]["graphs"]]
        check(g["captured"] == 1 and g["replays"] == 2 and e["captured"] == 0,
              f"dp_graph (a): {g['captured']} graphs replayed {g['replays']} times")
        check(recorded == steps and recorded[0] > 0,
              f"dp_graph (a): the graph recorded {recorded} NCCL collectives, an eager step "
              f"{steps}")
        for label, run in (("uncaptured", e), ("captured after the DDP run", g2)):
            check(g["losses"] == run["losses"] and all(torch.equal(g["params"][k], v)
                                                       for k, v in run["params"].items()),
                  f"dp_graph (a): graph and {label} steps differ: losses {g['losses']} vs "
                  f"{run['losses']}, parameters {_dpg_err(g['params'], run['params']):.3g} apart")
        check(g2["captured"] == 1 and g2["replays"] == 2,
              f"dp_graph (a): after the DDP run {g2['captured']} graphs, {g2['replays']} replays")
        check(g2["counts"] == e["counts"] == cap["ddp"]["counts"]
              and e["counts"]["augment"] == 2 * 3,
              f"dp_graph (a): launches {g2['counts']} captured vs {e['counts']} uncaptured vs "
              f"{cap['ddp']['counts']} with DDP (the first run's add the pipelines' first calls)")
        paths["dp_graph_capture"] = g["counts"]
        TRACED["dp_graph_capture"] = g["traced"]
        print(f"dp_graph (a) CNN32 fp32 step of 128+128 on a one-rank NCCL group as rank 0 of "
              f"a data mesh of two: {recorded[0]} NCCL collectives in the captured step (the "
              f"weights' total, batch norm's sums forward and backward, the gradient sum), as "
              f"in an eager step; 3 steps (1 eager, 1 graph replayed 2x) bit for bit the "
              f"uncaptured steps and the steps captured again after a per-step run with DDP "
              f"(losses {g['losses']}); NCCL kernels in the trace "
              f"{g['nccl']['traced']} for {g['nccl']['counted']} calls (a one-rank sum in place "
              f"launches none); port kernels traced {g['traced']['augment_apply']} [{card}]")
        ran.append("a capture on a one-rank NCCL group")
        # (b)
        one = _dpg_grid(tmp, "one", None)
        got = _dpg_group(tmp, [f"grid-rank{i}" for i in range(DPG_RANKS)],
                         ranks([f"grid-rank{i}" for i in range(DPG_RANKS)]))
        check(one["stacks"] == [DPG_SEEDS] and one["vmapped"] and not one["sharded"],
              f"dp_graph (b) one process: {one['stacks']}")
        for i, (r, share) in enumerate(zip(got, (2, 1))):
            check(r["vmapped"] and r["sharded"] and r["stacks"] == [share],
                  f"dp_graph (b) rank {i}: programs of {r['stacks']} members, not {share}")
            check(r["captures"] and all(r["captures"]),
                  f"dp_graph (b) rank {i}: its programs captured {r['captures']} graphs")
            check(r["aucs"] == got[0]["aucs"] and r["losses"] == got[0]["losses"],
                  f"dp_graph (b) rank {i}: logs other seeds' numbers than rank 0")
            for k in range(DPG_SEEDS):
                d_auc, d_score, held = _tie_or_close(r["aucs"][k], one["aucs"][k],
                                                     r["scores"][k], one["scores"][k])
                check(held, f"dp_graph (b) rank {i} seed {k}: AUROC {r['aucs'][k]} against "
                            f"{one['aucs'][k]}, scores {d_score} apart")
            l_err = _dpg_rel(r["losses"], one["losses"])
            check(l_err <= DPG_FP32_TOL, f"dp_graph (b) rank {i}: losses {l_err:.3g} rel from "
                                         f"one process's (tol {DPG_FP32_TOL})")
        for i, r in enumerate(got):
            paths[f"dp_graph_grid_rank{i}"] = r["counts"]
            TRACED[f"dp_graph_grid_rank{i}"] = r["traced"]
        print(f"dp_graph (b) a grid of {DPG_SEEDS} CNN32 seeds (SGD, {DPG_GRID_N}+{DPG_GRID_N} "
              f"images, {DPG_GRID_EPOCHS} epochs) on two gloo ranks sharing the card: members "
              f"{[r['stacks'] for r in got]}, graphs a runner {[r['captures'] for r in got]}; "
              f"AUROCs {got[0]['aucs']} vs {one['aucs']} in one process, losses {l_err:.3g} rel; "
              f"each rank's run traced, launches equal to the counters "
              f"{[{k: v['traced'] for k, v in r['traced'].items() if v['traced']} for r in got]} "
              f"[{card}]")
        ran.append("an uneven seed grid on two gloo ranks sharing the card")
        failed = []
        if cards >= DPG_RANKS:
            paths.update(_dpg_nccl(card, tmp, ranks, failed))
            ran.append("two NCCL ranks (ViT-B/32, CNN32, a 2 x 1 tiny CLIP)")
            if cards >= 4:
                tags = [f"tiny22-rank{i}" for i in range(4)]
                got = _dpg_group(tmp, tags, ranks(tags))
                one = _dpg_tiny(None)
                for i, r in enumerate(got):
                    r = r["tiny22"]
                    l_err, p_err = _dpg_rel(r["losses"], one["losses"]), _dpg_err(r["params"],
                                                                                   one["params"])
                    if not (r["captured"] and l_err <= DPG_FP32_TOL and p_err <= DPG_FP32_TOL):
                        failed.append(f"dp_graph (d) 2 x 2 rank {i}: {r['captured']} graphs, "
                                      f"losses {l_err:.3g}, parameters {p_err:.3g} from one "
                                      f"process's")
                print(f"dp_graph (d) tiny CLIP fp32 on a 2 x 2 mesh of four NCCL ranks, graph "
                      f"path: losses {l_err:.3g} rel and parameters {p_err:.3g} from one "
                      f"process's [{card}]")
                ran.append("a 2 x 2 tiny CLIP on four NCCL ranks")
        not_run = ([] if cards >= DPG_RANKS else
                   ["(c) and the 2 x 1 mesh of (d): two NCCL ranks need two cards"]) + (
            [] if cards >= 4 else ["the 2 x 2 mesh of (d): it needs four cards"])
        print(f"dp_graph on {cards} card(s): ran {'; '.join(ran)}; not run: "
              f"{'; '.join(not_run) or 'nothing'}")
        check(not failed, "; ".join(failed))
        return paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dpg_nccl(card: str, tmp: str, ranks, failed: list) -> dict:
    """(c) and the 2 x 1 part of (d) of ``phase_dp_graph``: two NCCL ranks
    against one process. A hold that fails is added to ``failed`` (the
    phase fails after its lines are printed: a run on several cards is
    dear)."""
    tags = [f"nccl-rank{i}" for i in range(DPG_RANKS)]
    got = _dpg_group(tmp, tags, ranks(tags))
    check("collectives on nccl" in got[0]["mesh"], f"dp_graph (c): {got[0]['mesh']}")
    one = {}
    for name, build in (("cnn", _dpg_conv), ("vit", _dpg_vit)):
        tr, ds = build(None) if name == "vit" else build(
            None, 2 * BATCH, DPG_CONV_STEPS * 2 * BATCH, DPG_EPOCHS, DPG_CONV_MILESTONES)
        one[name] = _dpg_train(tr, ds, False)
        del tr, ds
    one["tiny"] = _dpg_tiny(None)

    def hold(cond: bool, msg: str):
        if not cond:
            failed.append(msg)

    paths = {}
    for name, bf16 in (("cnn", False), ("vit", True)):
        tol = DPG_BF16_TOL if bf16 else DPG_FP32_TOL
        lines = []
        for i, r in enumerate(got):
            g, e, u, o = r[name]["graph"], r[name]["eager"], r[name]["graph_untraced"], one[name]
            what = f"dp_graph (c) {name} rank {i}"
            # CNN32's milestone: a graph a learning rate, captured again on both ranks
            graphs_want = 1 + (0 if bf16 else len(DPG_CONV_MILESTONES))
            hold(g["captured"] == u["captured"] == graphs_want and g["replays"] > 0
                 and e["captured"] == 0,
                 f"{what}: {g['captured']} graphs (untraced {u['captured']}, want "
                 f"{graphs_want}), {g['replays']} replays")
            hold(all(step == rec > 0 for step, rec in g["collectives"]["graphs"]),
                 f"{what}: NCCL collectives [an eager step's, recorded] a capture "
                 f"{g['collectives']['graphs']}")
            hold(g["nccl"]["traced"] == g["nccl"]["counted"] > 0,
                 f"{what}: NCCL kernels in the trace {g['nccl']}")
            for way, run in (("per-step", e), ("one process", o), ("untraced graph", u)):
                l_err = _dpg_rel(g["losses"], run["losses"])
                hold(l_err <= tol, f"{what}: graph losses {l_err:.3g} rel from the {way} run's "
                                   f"(tol {tol:.3g})")
            held = ""
            if not bf16:
                # per-step: the same ranks, every tensor to 1e-5; one process:
                # each tensor over max(1, |max|) (``_state_err``, as phase
                # resident holds CNN32's state): the batch-norm averages reach
                # about 5, and two ranks' global sums add in another order
                p_err, o_err = _dpg_err(g["params"], e["params"]), _state_err(g["params"],
                                                                               o["params"])
                worst = max(o["params"], key=lambda k: float((g["params"][k]
                                                             - o["params"][k]).abs().max()))
                # the control: each rank's own gradient share in the sum's place
                w_err = _state_err(r[name]["own_grads"]["params"], o["params"])
                hold(p_err <= DPG_FP32_TOL, f"{what}: parameters {p_err:.3g} from per-step's")
                hold(o_err <= DPG_FP32_TOL, f"{what}: parameters {o_err:.3g} of max(1, |max|) "
                                            f"from one process's")
                hold(w_err > DPG_FP32_TOL, f"{what}: a rank's own gradients in the sum's place "
                                           f"train parameters {w_err:.3g} of max(1, |max|) "
                                           f"from one process's: the hold would pass them")
                held = (f"parameters {p_err:.3g} from per-step, {o_err:.3g} of max(1, |max|) "
                        f"from one process (largest apart: {worst}, "
                        f"{float((g['params'][worst] - o['params'][worst]).abs().max()):.3g} of "
                        f"|max| {float(o['params'][worst].abs().max()):.3g}), each rank's own "
                        f"gradients in the sum's place {w_err:.3g}; ")
            d_auc, d_score, tie = _tie_or_close(g["auroc"], o["auroc"], g["scores"], o["scores"])
            hold(tie, f"{what}: AUROC {g['auroc']} against one process's {o['auroc']}, scores "
                      f"{d_score} apart")
            hold(u["counts"] == e["counts"], f"{what}: launches {u['counts']} graph vs "
                                             f"{e['counts']} per-step")
            path = f"dp_graph_{name}_nccl-rank{i}"
            paths[path] = g["counts"]
            TRACED[path] = g["traced"]
            captured = [rec for _, rec in g["collectives"]["graphs"]]
            lines.append(f"rank {i}: step {u['step_ms']:.2f} ms graph vs {e['step_ms']:.2f} "
                         f"per-step; losses {_dpg_rel(g['losses'], e['losses']):.3g} rel from "
                         f"per-step, {_dpg_rel(g['losses'], o['losses']):.3g} from one process; "
                         f"{held}AUROC {g['auroc']:.6f} vs {o['auroc']:.6f}, scores "
                         f"{d_score:.3g} apart; NCCL kernels traced {g['nccl']['traced']} for "
                         f"{g['nccl']['counted']} calls ({g['nccl']['kernels']}); collectives in "
                         f"each captured step {captured}; fused and augmentation kernels traced "
                         f"{ {k: v['traced'] for k, v in g['traced'].items() if v['traced']} }")
        print(f"dp_graph (c) {name} {'bf16 ViT-B/32' if bf16 else 'fp32 CNN32'} at 128+128 a "
              f"rank, two NCCL ranks: one process (256+256) {one[name]['step_ms']:.2f} ms a "
              f"step; " + "; ".join(lines) + f" [{card}]")
    for i, r in enumerate(got):
        t, o = r["tiny21"], one["tiny"]
        l_err, p_err = _dpg_rel(t["losses"], o["losses"]), _dpg_err(t["params"], o["params"])
        hold(t["captured"] and l_err <= DPG_FP32_TOL and p_err <= DPG_FP32_TOL,
             f"dp_graph (d) 2 x 1 rank {i}: {t['captured']} graphs, losses {l_err:.3g}, "
             f"parameters {p_err:.3g} from one process's")
    print(f"dp_graph (d) tiny CLIP fp32 on a 2 x 1 mesh of two NCCL ranks, graph path: losses "
          f"{l_err:.3g} rel and parameters {p_err:.3g} from one process's [{card}]")
    return paths


def _read_json(logdir: str, name: str) -> dict:
    with open(os.path.join(logdir, f"{name}.json")) as f:
        return json.load(f)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import eoe_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]} s")
        return out

    card = timed("card", phase_card)
    timed("build", phase_build)
    if "--phase" in sys.argv:   # one phase alone: its holds and lines, no result lines
        alone = {"resident": phase_resident, "dp": phase_dp, "tp": phase_tp,
                 "dp_graph": phase_dp_graph, "cbam": phase_cbam,
                 "long_attention": phase_long_attention, "vitl14": phase_vitl14}
        name = sys.argv[sys.argv.index("--phase") + 1]
        check(name in alone, f"--phase takes one of {sorted(alone)}")
        timed(name, alone[name], card)
        print(f"phase {name} alone: total {time.perf_counter() - t_start:.1f} s")
        return
    rows = timed("kernels", phase_kernels, card)
    bwd_rows = timed("kernels_bwd", phase_kernels_bwd, card)
    group_rows, group_bwd_rows = timed("kernels_group", phase_kernels_group, card)
    flash_rows = timed("kernels_flash", phase_kernels_flash, card)
    aug_rows = timed("augment", phase_augment, card)
    cbam_rows = timed("cbam", phase_cbam, card)
    long_rows = timed("long_attention", phase_long_attention, card)
    paths = {"serving": timed("serving", phase_slice, card)}
    import numpy as np
    data = _combined(np.random.default_rng(SEED), ACCEPTANCE_SPECS)
    paths["training"], paths["training_fp32"] = timed("training", phase_train, card, data)
    paths["flash_serving"], paths["flash_training"] = timed("flash", phase_flash, card, data)
    paths["group_training"], paths["group_training_fp32"] = timed("group", phase_group, card,
                                                                  data)
    del data
    paths["conv_training"] = timed("conv_training", phase_conv_training, card)
    paths["wrn_training"] = timed("wrn_training", phase_wrn_training, card)
    paths["vitl14_training"] = timed("vitl14", phase_vitl14, card)
    paths["vitl14_training"].pop("peak_bytes")
    paths.update(timed("resident", phase_resident, card))
    timed("filters", phase_filters, card)
    paths["cli_clip"], paths["cli_conv"] = timed("cli", phase_cli, card)
    paths["folder_clip"], paths["folder_conv"] = timed("folder", phase_folder, card)
    paths["evolve"] = timed("evolve", phase_evolve, card)
    paths["custom"] = timed("custom", phase_custom, card)
    (paths["vm_conv"], paths["vm_wrn"], paths["vm_clip"], paths["vm_evolve"],
     paths["vm_wrn_runners"]) = timed("vmapped", phase_vmapped, card)
    timed("ga_distances", phase_ga_distances, card)
    paths["clip_rn50"] = timed("clip_rn50", phase_clip_rn50, card)
    paths["import"] = timed("import", phase_import, card)
    timed("pool", phase_pool, card)
    per_step = timed("dp", phase_dp, card)   # phase dp's ranks: the per-step loop, untraced
    paths.update(per_step)
    paths.update(timed("tp", phase_tp, card))
    paths.update(timed("dp_graph", phase_dp_graph, card))

    def by_path(kernel):
        return {path: counts[kernel] for path, counts in paths.items()}

    def traced_by_path(family):
        """The family's launches in the traces of each path's traced runs,
        beside the counters' over the same runs (paths where either is not
        0); the fused kernels' families sum both grids."""
        return {path: fams[family] for path, fams in TRACED.items()
                if fams[family]["traced"] or fams[family]["counted"]}

    def variants_by_path(kernel):
        """The variant each path's launches took: the fused forwards' by the
        path's dtype (bf16 on the tensor cores, fp32 on register tiles), the
        fused backwards' fp32 designs and the flash kernel's as counted."""
        out = {}
        for path, counts in paths.items():
            if not counts[kernel]:
                continue
            if kernel == "flash":
                tc, tile = counts["flash_tc"], counts["flash_tile"]
                out[path] = {k: v for k, v in (("tensor cores", tc), ("fp32 register tiles", tile),
                                               ("CUDA cores", counts["flash"] - tc - tile)) if v}
            elif kernel in ("bwd", "group_bwd") and PATH_DTYPES[path] == "fp32":
                out[path] = {f"fp32 register tiles, {name}": counts[key]
                             for key, name in BWD_DESIGNS.items() if counts[key]}
            else:
                name = "fp32 register tiles" if PATH_DTYPES[path] == "fp32" else "tensor cores"
                out[path] = {name: counts[kernel]}
        return out

    def fp32(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "max_abs_err", "design") if k in row}

    main_shape = (*SHAPES[0], "torch.bfloat16")            # the training shape
    flash_shape = (*FLASH_SHAPES[0], "torch.bfloat16")     # the image tower, as trained
    f32_shape, f32_flash = (*SHAPES[0], "torch.float32"), (*FLASH_SHAPES[0], "torch.float32")

    def rank_heads(table):
        """A kernel's rows at a rank's heads (phase tp), bf16 and fp32."""
        return {table[(*shape, dt)]["shape"]: fp32(table[(*shape, dt)])
                for shape in RANK_SHAPES for dt in ("torch.bfloat16", "torch.float32")}

    source = "eoe_tpu_torch/csrc/fused_qkv_attention.cu"
    kernels = [
        {"name": "fused_qkv_attention", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:216", "launches": paths["training"]["fwd"],
         "launches_by_path": by_path("fwd"), "variants_by_path": variants_by_path("fwd"),
         "traced_by_path": traced_by_path("fused_qkv_fwd"),
         **rows[main_shape], "fp32": fp32(rows[f32_shape]), "rank_heads": rank_heads(rows)},
        {"name": "fused_qkv_attention_bwd", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:294", "launches": paths["training"]["bwd"],
         "launches_by_path": by_path("bwd"), "variants_by_path": variants_by_path("bwd"),
         "traced_by_path": traced_by_path("fused_qkv_bwd"),
         **bwd_rows[main_shape], "fp32": fp32(bwd_rows[f32_shape]),
         "rank_heads": rank_heads(bwd_rows)},
        {"name": "flash_attention", "route": "cuda",
         "source": "eoe_tpu_torch/csrc/flash_attention.cu",
         "replaces": "eoe_tpu/ops/attention.py:41",
         "launches": paths["flash_training"]["flash"], "launches_by_path": by_path("flash"),
         "variants_by_path": variants_by_path("flash"),
         "traced_by_path": traced_by_path("flash"), **flash_rows[flash_shape],
         "fp32": fp32(flash_rows[f32_flash])},
        {"name": "fused_qkv_attention_group", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:330",
         "launches": paths["group_training"]["group_fwd"],
         "launches_by_path": by_path("group_fwd"),
         "variants_by_path": variants_by_path("group_fwd"),
         "traced_by_path": traced_by_path("fused_qkv_fwd"), **group_rows[main_shape],
         "fp32": fp32(group_rows[f32_shape])},
        {"name": "fused_qkv_attention_group_bwd", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:343",
         "launches": paths["group_training"]["group_bwd"],
         "launches_by_path": by_path("group_bwd"),
         "variants_by_path": variants_by_path("group_bwd"),
         "traced_by_path": traced_by_path("fused_qkv_bwd"), **group_bwd_rows[main_shape],
         "fp32": fp32(group_bwd_rows[f32_shape])},
    ]
    # the augmentation kernels: the acceptance stack's crop step on uint8 (the
    # training path) in the row, every stack and input dtype under "stacks"
    aug_source = "eoe_tpu_torch/csrc/augment.cu"
    for kernel, key, replaces in (("augment_stats", "stats", "eoe_tpu/ops/preprocess.py:322"),
                                  ("augment_apply", "apply", "eoe_tpu/ops/preprocess.py:281")):
        count = "augment_stats" if key == "stats" else "augment"
        kernels.append({
            "name": kernel, "route": "cuda", "source": aug_source, "replaces": replaces,
            "launches": paths["training"][count], "launches_by_path": by_path(count),
            "traced_by_path": traced_by_path(kernel),
            **aug_rows[("acceptance", "uint8")][key],
            "stacks": {f"{s} {d}": row[key] for (s, d), row in aug_rows.items() if row[key]},
            "steps": {f"{s} {d}": row["step"] for (s, d), row in aug_rows.items()}})
    cbam_source = "eoe_tpu_torch/csrc/cbam.cu"
    for name, count, family in (("cbam", "cbam", "cbam_fwd"), ("cbam_bwd", "cbam_bwd", "cbam_bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": cbam_source,
            "replaces": "eoe_tpu_torch/models/cbam.py's composition (XLA fuses it on the TPU)",
            "launches": paths["wrn_training"][count], "launches_by_path": by_path(count),
            "traced_by_path": traced_by_path(family),
            "rows": {dt: row for dt, row in cbam_rows.items()}})
    for name, count, family, row in (("long_qkv_attention", "long", "long_fwd", "fwd"),
                                     ("long_qkv_attention_bwd", "long_bwd", "long_bwd_dkdv",
                                      "bwd")):
        kernels.append({
            "name": name, "route": "cuda", "source": "eoe_tpu_torch/csrc/flash_attention.cu",
            "replaces": "eoe_tpu_torch/ops/attention.py's default_attention at 128 < s <= 1024 "
                        "(the JAX package runs its default_attention there)",
            "launches": paths["vitl14_training"][count], "launches_by_path": by_path(count),
            "traced_by_path": traced_by_path(family), **long_rows[row]})
    missing = sorted(p for p in paths if p not in per_step and p not in TRACED)
    check(not missing, f"counted paths without a traced run: {missing}")
    print(f"traced counted runs (the port's kernels in the trace = the counters): "
          f"{sorted(TRACED)}; untraced: phase dp's {sorted(per_step)} (eager steps on the "
          f"per-step loop, counted where a wrapper launches); "
          f"ending and reading the traces took {sum(TRACE_SECONDS):.1f} s of host time, the "
          f"longest {max(TRACE_SECONDS):.1f} s")
    print(f"phases (s): {seconds}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:   # one process of phase dp
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        dp_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--tp-child"]:   # one process of phase tp
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        tp_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--dpg-child"]:   # one process of phase dp_graph
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        dpg_child(*sys.argv[2:4])
    else:
        main()
