#!/usr/bin/env python3
"""Design choices of the attention kernels, measured on one NVIDIA GPU.

    python3 attention_variants.py

Builds ``eoe_tpu_torch/csrc/fused_qkv_attention.cu`` and
``eoe_tpu_torch/csrc/flash_attention.cu`` as they are ("base") and in
variants that each undo one of their choices, made by text substitution on
the sources into ``eoe_tpu_torch/_build/variants`` (ignored by git). The
bf16 fused-QKV kernels:
  pairs           outputs stored as 4-byte bf16 pairs straight from the mma
                  fragments, not staged through shared memory for 16-byte
                  stores (dq is stored as pairs in every build);
  dq_late         dq staged for 16-byte stores too: its packed fragments held
                  in registers through step 2, stored from the warp's Q rows
                  after a last barrier;
  no_min_blocks   the monolithic backward without its minimum of one
                  resident block, so that ptxas's occupancy heuristic
                  chooses its registers;
  group_min_blocks  the group backward with that minimum;
  heads_unrolled  the bf16 loops over a group's heads unrolled.
The fp32 fused-QKV backward (timed in fp32; the variants above in bf16),
the first two changing the register-tile products of common.cuh, which the
fp32 forward shares:
  pv_unrolled     f32_pv's loop over keys unrolled by 4, so that four keys'
                  loads can go out together;
  qk_unrolled     f32_qk's loop over columns fully unrolled, not by 4;
  recompute       every shape in the recompute design: step 1 reading each
                  quad's q and dout rows from global memory with only K and
                  V resident, the row statistics kept, not P and dS, and
                  step 2 recomputing S^T and dP^T (7 products, not 5) from
                  quads of k and v rows read from global memory.
The flash kernel's bf16 tensor-core variant:
  kv_per_32_rows  S <= 128: blocks of 32 query rows, each staging all of K and
                  V (the first design's grid), not one block per (image, head);
  stream_32_rows  128 < S: blocks of 32 query rows, not 64;
  kept_logits     128 < S, blocks of 32 rows: pass 1 keeps each thread's
                  logits in shared memory (128 KB at S=1024) and pass 2 reads
                  them back with V alone, instead of loading K again and
                  recomputing QK^T;
  divide          P as exp(x - m) / sum, a division per key as _kernel writes
                  it, not a multiplication by the row's reciprocal sum;
  mask_early      S <= 128: the mask terms loaded before QK^T, so that their
                  loads overlap the product, not after it.
Every flash variant but divide must give the base's bits; divide, within an
ulp of P, must stay within the smoke's 2e-2 of the base.
Prints the registers and spills of each build's d=64 kernels, then the
device time (``chip_smoke.time_ms``) of the fused forward and backward on
both grids at the training shape (n=256, s=50, H=12, d=64) and the text shape
(n=64, s=77, H=8, causal), in bf16 for the bf16 variants and in fp32 for the
fp32 ones, and of flash_attention in bf16 at the image shape
(256, 12, 50, 64), the text shape (10, 8, 77, 64) with the causal mask and
(2, 12, 1024, 64), in the order base, variants, variants reversed, base, and
checks that every variant gives the base's bits. Needs one card and nvcc;
imports nothing of JAX or eoe_tpu. The fp32 register tiles were not built
against a 3xTF32 tensor-core design (PERF.md).
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

DQ_PAIRS = """      bf16* dst = dq + out_b + (size_t)(row0 + g) * out_row + nt * 8 + c2;
      if (real_lo)
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
      if (real_hi)
        *reinterpret_cast<uint32_t*>(dst + (size_t)8 * out_row) =
            pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);"""
DQ_HELD = """      dq_pairs[nt][0] = pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
      dq_pairs[nt][1] = pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);"""
DQ_DECL = "  {\n    float acc[D / 8][4];\n"
DK_STORE = ("  tc_store_staged<D, KT>(acc, mul, Ks + row0 * Tl::kPitch, dk + out_b, out_row, "
            "row0, s);\n}")
DQ_STORE = DK_STORE[:-1] + """  __syncthreads();                     // every warp is done with Q
  {
    bf16* stage = Qs + row0 * Tl::kPitch;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(stage + g * Tl::kPitch + nt * 8 + c2) = dq_pairs[nt][0];
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * Tl::kPitch + nt * 8 + c2) = dq_pairs[nt][1];
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c = i % (D / 8);
      if (row0 + r < s)
        *reinterpret_cast<uint4*>(dq + out_b + (size_t)(row0 + r) * out_row + c * 8) =
            *reinterpret_cast<const uint4*>(stage + r * Tl::kPitch + c * 8);
    }
  }
}"""
MONO_BOUNDS = "__launch_bounds__(TcTile<D, KT>::kThreads, 1)\nfused_qkv_bwd_kernel_tc("
F32_DESIGN = "*design = f32_bwd_design<D>(s);"
PV_LOOP = "  for (int j = 0; j < n; ++j) {\n    const float4 pj = p[j];"
QK_LOOP = "#pragma unroll 4\n  for (int c4 = 0; c4 < D; c4 += 4) {"
GROUP_BOUNDS = "__launch_bounds__(TcTile<D, KT>::kThreads)\nfused_qkv_bwd_group_kernel_tc("
HEADS_FWD_TC = ("#pragma unroll 1\n  for (int i = 0; i < PER; ++i) {\n    if (i > 0) "
                "__syncthreads();  // the previous head's tiles are still being read\n    "
                "fwd_head_tc")
HEADS_BWD_TC = ("#pragma unroll 1\n  for (int i = 0; i < PER; ++i) {\n    if (i > 0) "
                "__syncthreads();  // the previous head's step 2 still reads its tiles\n    "
                "bwd_head_tc")
PAIRS_BODY = """
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (row0 + g < s)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + g) * row_elems + nt * 8 + c2) =
          pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    if (row0 + g + 8 < s)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + g + 8) * row_elems + nt * 8 + c2) =
          pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}"""


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        sys.exit(f"attention_variants.py: expected {count} of {old[:60]!r} in the source, found "
                 f"{src.count(old)}; update the variant to the source")
    return src.replace(old, new)


def _pairs(src: str) -> str:
    """tc_store_staged's body replaced by pair stores from the fragments."""
    start = src.index("__device__ __forceinline__ void tc_store_staged(")
    i = body = src.index("{", start) + 1
    depth = 1
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    return src[:body] + PAIRS_BODY + src[i:]


def _with_common(src: str, common: str) -> str:
    """The source with the text of ``common`` in place of its include."""
    return _sub(src, '#include "common.cuh"\n', common.replace("#pragma once\n", ""))


def variants(src: str, common: str) -> dict:
    dq_late = _sub(src, DQ_PAIRS, DQ_HELD)
    dq_late = _sub(dq_late, DQ_DECL, "  uint32_t dq_pairs[D / 8][2];\n" + DQ_DECL)
    dq_late = _sub(dq_late, DK_STORE, DQ_STORE)
    return {
        "base": src,
        "pv_unrolled": _with_common(src, _sub(common, PV_LOOP, "#pragma unroll 4\n" + PV_LOOP)),
        "qk_unrolled": _with_common(src, _sub(common, QK_LOOP, QK_LOOP.replace(" 4\n", "\n"))),
        "recompute": _sub(src, F32_DESIGN, "*design = kRecompute;"),
        "pairs": _pairs(src),
        "dq_late": dq_late,
        "no_min_blocks": _sub(src, MONO_BOUNDS, MONO_BOUNDS.replace(", 1)", ")")),
        "group_min_blocks": _sub(src, GROUP_BOUNDS, GROUP_BOUNDS.replace(")\n", ", 1)\n")),
        "heads_unrolled": _sub(_sub(src, HEADS_FWD_TC, HEADS_FWD_TC.replace(" 1\n", "\n")),
                               HEADS_BWD_TC, HEADS_BWD_TC.replace(" 1\n", "\n")),
    }


QW_ALL = "constexpr int QW = KT;  "
STREAM_ROWS = "constexpr int kTcRows = 64;"
VS_DECL = "  bf16* Vs = Ks + 2 * kKeyTile * P;\n"
PASS1_LOGITS = ("    tc_logits<2 * NB>(x, mk, t * kKeyTile, scale, s, mt_lo, mt_hi);\n"
                "    const float base_lo")
NORM, PROB = "return 1.f / l;", "return expf(__fsub_rn(x, m)) * n;"
MASK_AFTER = "  mma_abt<D, KT, P>(x, Qs + row0 * P, Ks);\n  tc_mask<2 * KT>(mk, 0, r_lo, mask, s);\n"
PASS2_HEAD = """  for_each_tile(n_tiles, load_kv, [&](int t, int buf) {
    float x[2 * NB][4], mk[2 * NB][4], mt_lo, mt_hi;
    mma_abt<D, NB, P>(x, qw, Ks + buf * kKeyTile * P);
    tc_mask<2 * NB>(mk, t * kKeyTile, r_lo, mask, s);
    tc_logits<2 * NB>(x, mk, t * kKeyTile, scale, s, mt_lo, mt_hi);
"""
KEPT_DECL = "  float* Ls = reinterpret_cast<float*>(Vs + 2 * kKeyTile * P);   // thread-private\n"
KEPT_STORE = """    for (int i = 0; i < 8 * NB; ++i)
      Ls[(t * 8 * NB + i) * NT + threadIdx.x] = x[i / 4][i % 4];
"""
KEPT_PASS2_HEAD = """  for_each_tile(n_tiles, load_v, [&](int t, int buf) {
    float x[2 * NB][4];
    for (int i = 0; i < 8 * NB; ++i) x[i / 4][i % 4] = Ls[(t * 8 * NB + i) * NT + threadIdx.x];
"""
STREAM_SMEM = """      constexpr size_t smem = (size_t)(kTcRows + 4 * kKeyTile) * P * sizeof(bf16);
      cudaError_t err = allow_smem(kernel, smem, smem, raised);"""
KEPT_SMEM = """      constexpr size_t tiles = (size_t)(kTcRows + 4 * kKeyTile) * P * sizeof(bf16);
      const size_t smem = tiles + (size_t)(s + kKeyTile - 1) / kKeyTile * kKeyTile * kTcRows * 4;
      cudaError_t err = allow_smem(kernel, smem, tiles + (size_t)kMaxSeq * kTcRows * 4, raised);"""


def flash_variants(src: str) -> dict:
    rows32 = _sub(src, STREAM_ROWS, STREAM_ROWS.replace("64", "32"))
    kept = _sub(rows32, VS_DECL, VS_DECL + KEPT_DECL)
    kept = _sub(kept, PASS1_LOGITS, PASS1_LOGITS.replace("    const float base_lo",
                                                         KEPT_STORE + "    const float base_lo"))
    kept = _sub(kept, PASS2_HEAD, KEPT_PASS2_HEAD)
    kept = _sub(kept, STREAM_SMEM, KEPT_SMEM)
    return {
        "base": src,
        "kv_per_32_rows": _sub(src, QW_ALL, "constexpr int QW = KT < 2 ? KT : 2;  "),
        "stream_32_rows": rows32,
        "kept_logits": kept,
        "divide": _sub(_sub(src, NORM, "return l;"), PROB,
                       "return __fdiv_rn(expf(__fsub_rn(x, m)), n);"),
        "mask_early": _sub(src, MASK_AFTER, "  tc_mask<2 * KT>(mk, 0, r_lo, mask, s);\n"
                           "  mma_abt<D, KT, P>(x, Qs + row0 * P, Ks);\n"),
    }


FUSED_ENTRIES = ("eoe_fused_qkv_attention_fwd", "eoe_fused_qkv_attention_group_fwd",
                 "eoe_fused_qkv_attention_bwd", "eoe_fused_qkv_attention_group_bwd")


def _build_all(sources: dict, out_dir) -> dict:
    """Builds every (source, variant) into its own library, one nvcc each, all
    started together; returns {(source, variant): (library path, ptxas log)}."""
    from eoe_tpu_torch.ops import _build

    def build(key):
        stem = f"{key[0].split('.')[0]}-{key[1]}"
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(sources[key])
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"attention_variants.py: {stem} failed to build:\n{proc.stderr[-3000:]}")
        return key, (so, proc.stdout + proc.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(build, sources))


F32_VARIANTS = ("pv_unrolled", "qk_unrolled", "recompute")


def _time_fused(cs, libs, card):
    """The bf16 variants in bf16, the fp32 ones (against the base) in fp32."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for dtype in (torch.bfloat16, torch.float32):
        names = [k for k in libs if (k in F32_VARIANTS) == (dtype == torch.float32)]
        names = ["base"] + [k for k in names if k != "base"]
        order = names + names[::-1]
        for n, s, h, d, causal in ((256, 50, 12, 64, False), (64, 77, 8, 64, True)):
            qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, s, h * d, generator=g, device="cuda").to(dtype)
            tag = f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {str(dtype)[6:]}"
            outs = {}
            for name in order:
                lib = libs[name]
                out = torch.empty(n, s, h * d, dtype=dtype, device="cuda")
                dqkv, group_dqkv = torch.empty_like(qkv), torch.empty_like(qkv)
                args = (n, s, h, d, 0 if dtype == torch.float32 else 1, int(causal), d ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                design = ctypes.byref(ctypes.c_int(-1))
                calls = {
                    "fwd": lambda: lib.eoe_fused_qkv_attention_fwd(qkv.data_ptr(), out.data_ptr(),
                                                                   *args),
                    "group fwd": lambda: lib.eoe_fused_qkv_attention_group_fwd(
                        qkv.data_ptr(), out.data_ptr(), *args),
                    "bwd": lambda: lib.eoe_fused_qkv_attention_bwd(
                        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), *args, design),
                    "group bwd": lambda: lib.eoe_fused_qkv_attention_group_bwd(
                        qkv.data_ptr(), dout.data_ptr(), group_dqkv.data_ptr(), *args,
                        design),
                }
                times = {k: cs.time_ms(f) for k, f in calls.items()}
                torch.cuda.synchronize()
                outs[name] = (out.clone(), dqkv.clone(), group_dqkv.clone())
                print(f"{tag} {name}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
                      + f" [{card}]")
            for name, res in outs.items():
                if not all(torch.equal(a, b) for a, b in zip(res, outs["base"])):
                    sys.exit(f"attention_variants.py: {name} gives other bits than base")
            print(f"{tag}: every variant gives the base's bits")


def _time_flash(cs, libs, card):
    import torch
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    order = list(libs) + list(libs)[::-1]
    for n, h, s, d, causal in ((256, 12, 50, 64, False), (10, 8, 77, 64, True),
                               (2, 12, 1024, 64, False)):
        q, k, v = (torch.randn(n, h, s, d, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        mask = torch.full((s, s), float("-inf"), device="cuda").triu(1) if causal else None
        out = torch.empty((n, s, h, d), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
        variant = ctypes.c_int(-1)
        outs = {}
        for name in order:
            lib = libs[name]

            def call():
                err = lib.eoe_flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(), n, h, s, d, 1,
                    strides, d ** -0.5, torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(variant))
                if err or variant.value != 1:
                    sys.exit(f"attention_variants.py: flash {name} returned {err}, variant "
                             f"{variant.value}")

            ms = cs.time_ms(call)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            print(f"flash n={n} H={h} S={s} d={d} {'causal' if causal else 'full'} {name}: "
                  f"{ms:.4f} ms [{card}]")
        for name, res in outs.items():
            if name == "divide":
                err = (res.float() - outs["base"].float()).abs().max().item()
                if err > 2e-2:
                    sys.exit(f"attention_variants.py: flash divide is {err} off the base")
                print(f"flash S={s}: divide within {err:.3g} of the base")
            elif not torch.equal(res, outs["base"]):
                sys.exit(f"attention_variants.py: flash {name} gives other bits than base")
        print(f"flash S={s}: every other variant gives the base's bits")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_variants.py: torch.cuda.is_available() is false: it needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from eoe_tpu_torch.ops import _build

    card = cs.phase_card()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    fused_src = (_build.CSRC_DIR / "fused_qkv_attention.cu").read_text()
    flash_src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    common = (_build.CSRC_DIR / "common.cuh").read_text()
    sources = {("fused_qkv_attention.cu", k): v for k, v in variants(fused_src, common).items()}
    sources.update({("flash_attention.cu", k): v for k, v in flash_variants(flash_src).items()})
    built = _build_all(sources, out_dir)

    P, I = ctypes.c_void_p, ctypes.c_int
    fa = [P, P, I, I, I, I, I, I, ctypes.c_float, P]
    fused, flash = {}, {}
    for (source, name), (so, log) in built.items():
        for line in cs.ptxas_summary(log):
            shown = "<bf16, 64," in line or "fused_qkv_bwd_kernel<fp32, 64," in line
            if shown and ("flash" not in source or "_tc" in line):
                print(f"ptxas {source.split('.')[0]} {name}: {line}")
        lib = ctypes.CDLL(str(so))
        if source == "flash_attention.cu":
            lib.eoe_flash_attention_fwd.argtypes = [
                P, P, P, P, P, I, I, I, I, I, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, P,
                ctypes.POINTER(I)]
            flash[name] = lib
        else:
            ba = [P, P, P] + fa[2:] + [ctypes.POINTER(I)]
            for entry, args in zip(FUSED_ENTRIES, (fa, fa, ba, ba)):
                getattr(lib, entry).argtypes = args
            fused[name] = lib
    _time_fused(cs, fused, card)
    _time_flash(cs, flash, card)


if __name__ == "__main__":
    main()
