#!/usr/bin/env python3
"""Design choices of the bf16 fused-QKV attention kernels, measured on one
NVIDIA GPU.

    python3 attention_variants.py

Builds ``eoe_tpu_torch/csrc/fused_qkv_attention.cu`` as it is ("base") and in
variants that each undo one of its choices, made by text substitution on the
source into ``eoe_tpu_torch/_build/variants`` (ignored by git):
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
  heads_unrolled  the loops over a group's heads unrolled.
Prints the registers and spills of each build's bf16 d=64 kernels, then the
device time (``chip_smoke.time_ms``) of the forward and backward on both grids
at the training shape (n=256, s=50, H=12, d=64) and the text shape (n=64,
s=77, H=8, causal), in the order base, variants, variants reversed, base, and
checks that every variant gives the base's bits. Needs one card and nvcc;
imports nothing of JAX or eoe_tpu.
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
GROUP_BOUNDS = "__launch_bounds__(TcTile<D, KT>::kThreads)\nfused_qkv_bwd_group_kernel_tc("
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


def variants(src: str) -> dict:
    dq_late = _sub(src, DQ_PAIRS, DQ_HELD)
    dq_late = _sub(dq_late, DQ_DECL, "  uint32_t dq_pairs[D / 8][2];\n" + DQ_DECL)
    dq_late = _sub(dq_late, DK_STORE, DQ_STORE)
    return {
        "base": src,
        "pairs": _pairs(src),
        "dq_late": dq_late,
        "no_min_blocks": _sub(src, MONO_BOUNDS, MONO_BOUNDS.replace(", 1)", ")")),
        "group_min_blocks": _sub(src, GROUP_BOUNDS, GROUP_BOUNDS.replace(")\n", ", 1)\n")),
        "heads_unrolled": _sub(src, "#pragma unroll 1\n  for (int i = 0; i < PER; ++i)",
                               "#pragma unroll\n  for (int i = 0; i < PER; ++i)", count=2),
    }


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_variants.py: torch.cuda.is_available() is false: it needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from eoe_tpu_torch.ops import _build

    card = cs.phase_card()
    src = (_build.CSRC_DIR / "fused_qkv_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    sources = variants(src)

    def build(name):
        cu = out_dir / f"{name}.cu"
        cu.write_text(sources[name])
        so = out_dir / f"{name}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"attention_variants.py: {name} failed to build:\n{proc.stderr[-3000:]}")
        return name, so, proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per variant, together
        built = list(pool.map(build, sources))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    fa = [P, P, I, I, I, I, I, I, ctypes.c_float, P]
    for name, so, log in built:
        for line in cs.ptxas_summary(log):
            if "<bf16, 64," in line:
                print(f"ptxas {name}: {line}")
        lib = ctypes.CDLL(str(so))
        for entry, args in (("eoe_fused_qkv_attention_fwd", fa),
                            ("eoe_fused_qkv_attention_group_fwd", fa),
                            ("eoe_fused_qkv_attention_bwd", [P, P, P] + fa[2:]),
                            ("eoe_fused_qkv_attention_group_bwd", [P, P, P, P, P] + fa[2:])):
            getattr(lib, entry).argtypes = args
        libs[name] = lib

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    order = list(libs) + list(libs)[::-1]
    for n, s, h, d, causal in ((256, 50, 12, 64, False), (64, 77, 8, 64, True)):
        qkv = torch.randn(n, s, 3 * h * d, generator=g, device="cuda").bfloat16()
        dout = torch.randn(n, s, h * d, generator=g, device="cuda").bfloat16()
        outs = {}
        for name in order:
            lib = libs[name]
            out = torch.empty(n, s, h * d, dtype=torch.bfloat16, device="cuda")
            dqkv = torch.empty_like(qkv)
            parts = [torch.empty_like(out) for _ in range(3)]
            args = (n, s, h, d, 1, int(causal), d ** -0.5, torch.cuda.current_stream().cuda_stream)
            calls = {
                "fwd": lambda: lib.eoe_fused_qkv_attention_fwd(qkv.data_ptr(), out.data_ptr(), *args),
                "group fwd": lambda: lib.eoe_fused_qkv_attention_group_fwd(
                    qkv.data_ptr(), out.data_ptr(), *args),
                "bwd": lambda: lib.eoe_fused_qkv_attention_bwd(
                    qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), *args),
                "group bwd": lambda: lib.eoe_fused_qkv_attention_group_bwd(
                    qkv.data_ptr(), dout.data_ptr(), *(t.data_ptr() for t in parts), *args),
            }
            times = {k: cs.time_ms(f) for k, f in calls.items()}
            torch.cuda.synchronize()
            outs[name] = (out.clone(), dqkv.clone(), *(t.clone() for t in parts))
            print(f"n={n} s={s} H={h} d={d} {'causal' if causal else 'full'} {name}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()) + f" [{card}]")
        for name, res in outs.items():
            if not all(torch.equal(a, b) for a, b in zip(res, outs["base"])):
                sys.exit(f"attention_variants.py: {name} gives other bits than base")
        print(f"n={n} s={s}: every variant gives the base's bits")


if __name__ == "__main__":
    main()
