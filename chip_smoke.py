#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: the card's name and power limit, as nvidia-smi reports them;
  2. build: every kernel of the port (the fused-QKV attention forward and
     backward, one source), compiled from this checkout's sources;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, with its time beside the plain version's and
     one PyTorch library call's (a yardstick the port never calls): SDPA's
     forward, and SDPA's backward through a retained forward;
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
     forward per eval batch. Then 3 fp32 steps (TF32 off, deterministic
     pipeline) twice, through the kernels and through their plain versions
     (``fused_qkv_attention_ref``), held against each other; and the
     snapshot served through ``AnomalyScorer``, held against ``eval_cls``.
Each path's launch counts are set to 0 just before it and read just after.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or eoe_tpu.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                                    # H100 SXM, data sheet
PEAK_OPS_PER_S = {"torch.float32": 67e12, "torch.bfloat16": 989e12}  # CUDA-core fp32; bf16 dense
SEED = 0
REQUESTS = (256, 100, 37)
BATCH = 128


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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


def phase_build():
    from eoe_tpu_torch.ops import _build, attention
    t0 = time.perf_counter()
    attention._library()  # builds csrc/fused_qkv_attention.cu (forward and backward), then loads it
    print(f"build: {attention.SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(attention.SOURCE).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


# (n, s, heads, d, causal): the ViT-B/32 image tower at the training and
# serving batch (n = 256 images), the text tower, a ragged causal case, d=128
SHAPES = [(256, 50, 12, 64, False), (64, 77, 8, 64, True),
          (3, 21, 4, 64, True), (2, 10, 2, 128, True)]


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
    two differ in summation order only, 2e-5 of the largest gradient. bf16:
    an order flip can move dS across a rounding boundary before the second
    products, and the output is rounded once more: 2^-5 of the largest."""
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import _bwd_kernel, fused_qkv_attention_bwd_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    for n, s, h, d, causal in SHAPES:
        for dtype, rel in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -5)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, s, h * d, generator=g, device="cuda").to(dtype)
            dqkv = _bwd_kernel(qkv, dout, h, causal)
            ref = fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
            torch.cuda.synchronize()
            err = (dqkv.float() - ref.float()).abs().max().item()
            tol = rel * ref.float().abs().max().item()
            tag = f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
            check(err <= tol, f"fused_qkv_attention backward {tag}: max abs err {err} > {tol}")
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
                library_ms=sdpa_ms, shape=tag)
            print(f"kernel fused_qkv_attention_bwd {tag}: max_abs_err {err:.3g} (tol {tol:.3g}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bwd {sdpa_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}) [{card}]")
    return rows


def phase_slice(card: str) -> int:
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
    fused_qkv_attention.launches = 0
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS)
    prompt_launches = fused_qkv_attention.launches
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=BATCH, center=center)
    scores, seconds = [], []
    for images in requests:
        t0 = time.perf_counter()
        scores.append(scorer.score(images))  # ends in a device->host copy
        seconds.append(time.perf_counter() - t0)
    launches = fused_qkv_attention.launches
    # ---- end of the counted run

    batches = sum(-(-n // BATCH) for n in REQUESTS)
    layers = VIT_B32.vision_layers
    check(prompt_launches == VIT_B32.transformer_layers,
          f"prompt centre launched the kernel {prompt_launches} times, "
          f"expected {VIT_B32.transformer_layers}")
    check(launches == prompt_launches + layers * batches,
          f"main path launched the kernel {launches} times, expected "
          f"{prompt_launches} + {layers} x {batches} batches")
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
    return launches


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


def _trainer(model, train_specs, logger, dtype):
    """The JAX package's benchmark trainer (bench.py:123-127)."""
    from eoe_tpu_torch.training import TRAINER
    return TRAINER["hsc"](model=model, train_specs=train_specs, test_specs=CLIP_TEST_SPECS,
                          dataset="cifar10", oe_dataset="cifar100", datapath="", logger=logger,
                          epochs=TRAIN_EPOCHS, lr=1e-4, wdk=1e-3, milestones=[],
                          batch_size=BATCH, compute_dtype=dtype)


def phase_train(card: str) -> tuple:
    import tempfile

    import numpy as np
    import torch
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP, VIT_B32
    from eoe_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_ref
    from eoe_tpu_torch.utils.logger import Logger

    layers = VIT_B32.vision_layers
    rng = np.random.default_rng(SEED)
    ds, x_test = _combined(rng, ACCEPTANCE_SPECS)
    steps = TRAIN_EPOCHS * (TRAIN_N // BATCH)
    eval_batches = -(-TRAIN_TEST // BATCH)
    with tempfile.TemporaryDirectory() as logdir:
        logger = Logger(logdir, noname=True)
        trainer = _trainer(CLIP(VIT_B32, dtype=torch.bfloat16), ACCEPTANCE_SPECS, logger,
                           torch.bfloat16)
        trainer.ds = ds

        # ---- the main path, counted: train_cls, eval_cls, snapshot
        fused_qkv_attention.launches = fused_qkv_attention.bwd_launches = 0
        t0 = time.perf_counter()
        state, roc = trainer.train_cls(ds, 0, "airplane", 0, seed=SEED)
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        eroc, _ = trainer.eval_cls(state, ds, 0, "airplane", 0)
        t_eval = time.perf_counter() - t0
        path = trainer.snapshot("snapshot_cls0_it0", state, TRAIN_EPOCHS, ds.ds_statistics)
        fwd, bwd = fused_qkv_attention.launches, fused_qkv_attention.bwd_launches
        # ---- end of the counted run

        losses = trainer.step_losses
        check(len(losses) == steps and np.isfinite(losses).all(),
              f"training: expected {steps} finite losses, got {losses}")
        check(fwd == layers * (steps + eval_batches),
              f"training: {fwd} forward launches, expected {layers} x ({steps} steps + "
              f"{eval_batches} eval batches)")
        check(bwd == layers * steps, f"training: {bwd} backward launches, expected "
              f"{layers} x {steps} steps")
        eval_scores = np.array([v for _, v in sorted(
            (int(k), v) for k, v in _read_json(logdir, "eval_cls0_it0_anomaly_scores").items())])
        check(eval_scores.shape == (TRAIN_TEST,) and np.isfinite(eval_scores).all(),
              "eval_cls: bad scores")
        rates = [round(r, 1) for r in trainer.epoch_rates]
        print(f"train hsc bf16 ViT-B/32: {steps} steps of {BATCH}+{BATCH} images in "
              f"{t_train:.2f} s; img/s per epoch {rates}; losses "
              f"{[round(x, 5) for x in losses]}; train AUROC {roc.auc:.4f}, eval of "
              f"{TRAIN_TEST} in {t_eval:.2f} s, synthetic AUROC {eroc.auc:.4f}; launches "
              f"fwd {fwd} bwd {bwd} [{card}]")

        # the snapshot, served back through the first slice's scorer
        scorer = AnomalyScorer(path, CLIP(VIT_B32, dtype=torch.bfloat16), objective="hsc",
                               batch_size=BATCH, compute_dtype=torch.bfloat16)
        served = scorer.score(x_test)
        serve_err = float(np.abs(served - eval_scores).max())
        check(serve_err <= 1e-4, f"served snapshot differs from eval_cls by {serve_err}")
        print(f"train: snapshot served through AnomalyScorer, max score difference to "
              f"eval_cls {serve_err:.3g} (tol 1e-4)")
    del trainer, state, scorer
    torch.cuda.empty_cache()

    # fp32, deterministic pipeline: the kernels against their plain versions
    ds32, _ = _combined(np.random.default_rng(SEED + 1), CLIP_TEST_SPECS)
    runs = []
    for attention in ("kernels", "plain"):
        kw = {"qkv_attention": fused_qkv_attention_ref} if attention == "plain" else {}
        tr = _trainer(CLIP(VIT_B32, **kw), CLIP_TEST_SPECS, None, torch.float32)
        st = tr.init_state(SEED, ds32, 1)
        dev = tr.device
        xn = torch.from_numpy(ds32.train_set.gather_all()).to(dev)
        xo = torch.from_numpy(ds32.oe.train_set.gather_all()).to(dev)
        ln = torch.zeros(TRAIN_N, dtype=torch.int64, device=dev)
        lo = torch.ones(TRAIN_OE, dtype=torch.int64, device=dev)
        w = torch.ones(BATCH, device=dev)
        visual = [p for p in st.model.visual.parameters()]
        fused_qkv_attention.launches = fused_qkv_attention.bwd_launches = 0
        losses, grads = [], None
        for i in range(3):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            loss, *_ = tr.train_step(st, ds32, xn[sl], ln[sl], xo[sl], lo[sl], w, None)
            losses.append(loss.item())
            if i == 0:
                grads = [p.grad.clone() for p in visual]
        launches = (fused_qkv_attention.launches, fused_qkv_attention.bwd_launches)
        check(launches == ((3 * layers, 3 * layers) if attention == "kernels" else (0, 0)),
              f"fp32 {attention} run launched {launches}")
        runs.append((losses, grads, [p.detach().clone() for p in visual]))
        del tr, st, visual
    (lk, gk, pk), (lp, gp, pp) = runs
    g_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(gk, gp))
    l_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    p_err = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    check(g_err <= 1e-4, f"fp32 first-step gradients differ by {g_err} of their max")
    check(l_err <= 1e-5, f"fp32 losses differ by {l_err} (relative)")
    check(p_err <= 1e-5, f"fp32 visual parameters differ by {p_err} after 3 steps")
    print(f"train hsc fp32 kernels vs plain, 3 steps: gradient err {g_err:.3g} of max "
          f"(tol 1e-4), loss err {l_err:.3g} rel (tol 1e-5), parameter err {p_err:.3g} "
          f"(tol 1e-5); losses {[round(x, 6) for x in lk]} [{card}]")
    return fwd, bwd


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

    card = phase_card()
    phase_build()
    rows = phase_kernels(card)
    bwd_rows = phase_kernels_bwd(card)
    serve_launches = phase_slice(card)
    train_fwd, train_bwd = phase_train(card)

    main_shape = (256, 50, 12, 64, False, "torch.bfloat16")  # the training shape
    source = "eoe_tpu_torch/csrc/fused_qkv_attention.cu"
    kernels = [
        {"name": "fused_qkv_attention", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:216", "launches": train_fwd,
         "launches_by_path": {"serving": serve_launches, "training": train_fwd},
         **rows[main_shape]},
        {"name": "fused_qkv_attention_bwd", "route": "cuda", "source": source,
         "replaces": "eoe_tpu/ops/attention.py:294", "launches": train_bwd,
         "launches_by_path": {"serving": 0, "training": train_bwd},
         **bwd_rows[main_shape]},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
