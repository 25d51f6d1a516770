#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: the card's name and power limit, as nvidia-smi reports them;
  2. build: every kernel of the slice, compiled from this checkout's sources;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     fp32 (TF32 off) and bf16, with its time beside the plain version's and
     one PyTorch library call's (a yardstick the port never calls);
  4. slice: CLIP ViT-B/32 anomaly scoring at full width with random weights
     from seed 0: the CIFAR-10 one-vs-rest prompt centre, then three requests
     (256, 100 and 37 raw 32x32 uint8 images) through ``AnomalyScorer``, held
     against the same model run through the kernel's plain version; one
     request again with the HSC objective in bf16. The kernels' launch counts
     are set to 0 just before this phase's main path and read just after.

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


def attention_bound_ms(n, s, heads, d, causal, dtype) -> tuple:
    """Least time for the function: read qkv once and write the output once,
    and the two products' operations (causal rows need only their prefix)."""
    elem = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = n * s * 4 * heads * d * elem
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * n * heads * pairs * d
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
    attention._library()  # builds csrc/fused_qkv_attention.cu with nvcc, then loads it
    print(f"build: {attention.SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(attention.SOURCE).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from eoe_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_ref

    shapes = [(256, 50, 12, 64, False), (64, 77, 8, 64, True),
              (3, 21, 4, 64, True), (2, 10, 2, 128, True)]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for n, s, h, d, causal in shapes:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            out = fused_qkv_attention(qkv, h, causal)
            ref = fused_qkv_attention_ref(qkv, h, causal)
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
            plain_ms = time_ms(lambda: fused_qkv_attention_ref(qkv, h, causal))
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
    launches = phase_slice(card)

    main_row = rows[(256, 50, 12, 64, False, "torch.bfloat16")]
    kernel = {"name": "fused_qkv_attention", "route": "cuda",
              "source": "eoe_tpu_torch/csrc/fused_qkv_attention.cu",
              "replaces": "eoe_tpu/ops/attention.py:216",
              "launches": launches, **main_row}
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
