#!/usr/bin/env python3
"""Design choices of the augmentation kernels, measured on one NVIDIA GPU.

    python3 augment_variants.py           # the variants below, on this checkout
    python3 augment_variants.py --phase   # only chip_smoke's phase augment

Builds ``eoe_tpu_torch/csrc/augment.cu`` as it is ("base") and in variants
that each undo one of its choices, made by text substitution on the source
into ``eoe_tpu_torch/_build/variants`` (ignored by git):
  division     apply: uint8 converted by an IEEE division per value (the first
               design's), not the table of x / 255;
  fmodf        apply: the hue's remainders by fmodf and the sign rule (the
               first design's), not the exact shortcuts;
  scalar_out   apply: the noise read and the output written 4 bytes at a
               time, not in 16-byte vectors;
  sync_stage   apply: the source rows staged an element at a time by plain
               loads, not in 16-byte chunks by cp.async;
  one_stage    apply: each stage waited for together with the next one's
               copies, so that no copy overlaps a stage's arithmetic;
  ieee_div     apply: the HSV's and the normalisation's divisions by
               __fdiv_rn (the first design's), not its fast path alone;
  fast_div     apply: those divisions by __fdividef (not exact: its error
               against the base is printed);
  no_hue       apply: the HSV round trip left out (not exact): what the
               colour arithmetic costs;
  apply_occ    apply: at least 3 blocks an SM, not 4 (registers capped at
               80, not 64);
  half_rows    apply: stages of half as many rows (the launch geometry: twice
               the blocks, half their threads idle);
  full_rows    apply: as many rows a stage as a block has threads for, however
               few blocks that leaves (the launch geometry: CIFAR-10's 128
               crops of 32x32 in 128 blocks, not 256);
  whole_image  stats: the guard alone reading every row of the image, whole,
               not only the crop windows;
  one_load     stats: a thread's loads used as each arrives, not 3 issued
               first;
  four_loads   stats: 4 loads issued first, not 3;
  no_combine   stats: without the cluster's barriers and the combine in
               distributed shared memory (not exact: only the first block's
               rows count);
  no_math      stats: the staged chunks read and folded into one word, not
               summed or tested (not exact);
  stats_occ    stats: at least 4 blocks an SM, not 8 (registers capped at
               128, not 64);
  cluster_1    stats: one block per image, no cluster (a launch geometry of
               the same build, not a variant source).
Every variant but fast_div, no_hue, no_combine and no_math must give the
base's bits. Prints the registers and spills of each build's kernels, then
the device time (``chip_smoke.time_ms``) of the stats and apply kernels at
the crop steps of the acceptance and ImageNet-30 stacks (one half-batch of
128 raw 256x256x3 uint8 images, crops of 224) and of the apply kernel at the
CIFAR-10 stack's (32x32 padded by 4, uint8 and fp32), in the order base,
variants, variants reversed, base.

``--phase`` runs only ``chip_smoke.phase_card``, the build of augment.cu and
``chip_smoke.phase_augment`` from the directory this script is in, and
prints its rows as one JSON line: copied beside this checkout's
``chip_smoke.py`` into an unpacked older tree, it times that tree's kernels
with the same inputs and checks. Needs one card and nvcc; imports nothing of
JAX or eoe_tpu.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

APPLY_VARIANTS = ("division", "fmodf", "ieee_div", "scalar_out", "sync_stage", "one_stage",
                  "fast_div", "no_hue", "apply_occ", "half_rows", "full_rows")
STATS_VARIANTS = ("whole_image", "one_load", "four_loads", "no_combine", "no_math", "stats_occ",
                  "cluster_1")
INEXACT = ("fast_div", "no_hue", "no_combine", "no_math")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        sys.exit(f"augment_variants.py: the source no longer has {old!r}")
    return src.replace(old, new)


def _sub_in(src: str, kernel: str, old: str, new: str) -> str:
    """``_sub`` inside the body of ``kernel``."""
    start = src.index(f"{kernel}(const T*")
    end = src.index("\n}\n", start)
    return src[:start] + _sub(src[start:end], old, new) + src[end:]


def _divisions(src: str, fn: str) -> str:
    """The apply chain's divisions (the hue's and the normalisation's) by
    ``fn``."""
    start = src.index("__device__ __forceinline__ void shift_hue")
    end = src.index("\n}\n", start)
    body = src[start:end].replace("div_rn(", f"{fn}(")
    src = src[:start] + body + src[end:]
    src = _sub(src, "div_rn(__fsub_rn(res[u], nm[u % COUT]), ns[u % COUT], ny[u % COUT]);",
               f"{fn}(__fsub_rn(res[u], nm[u % COUT]), ns[u % COUT]);")
    return _sub(src, "r = div_rn(__fsub_rn(r, nm[u % COUT]), ns[u % COUT], ny[u % COUT]);",
                f"r = {fn}(__fsub_rn(r, nm[u % COUT]), ns[u % COUT]);")


def variants(src: str) -> dict:
    return {
        "base": src,
        "division": _sub(src, "if constexpr (kBytes) v[c] = table[px[c]];",
                         "if constexpr (kBytes) v[c] = unit(px[c]);"),
        "fmodf": _sub(_sub(src, "  const float m = copysignf(__fsub_rn(x, truncf(x)), x);\n"
                                "  return m < 0.f ? __fadd_rn(m, 1.f) : m;",
                           "  float m = fmodf(x, 1.f);\n"
                           "  if (m < 0.f) m = __fadd_rn(m, 1.f);\n"
                           "  return m;"),
                      "{ return k >= 6.f ? __fsub_rn(k, 6.f) : k; }",
                      "{ return fmodf(k, 6.f); }"),
        "scalar_out": _sub(src, "if (geo.vec_out && np == 4 && (o & 3) == 0) {", "if (false) {"),
        "sync_stage": _sub(src, "uintptr_t>(x) % 16 == 0 && row_bytes % 16 == 0,",
                           "uintptr_t>(x) % 16 == 0 && false,"),
        "one_stage": _sub_in(src, "augment_apply_kernel", "eoe::cp_async_wait<1>();",
                             "eoe::cp_async_wait<0>();"),
        "one_load": _sub(src, "kInFlight = 3;", "kInFlight = 1;"),
        "four_loads": _sub(src, "kInFlight = 3;", "kInFlight = 4;"),
        "ieee_div": _divisions(src, "__fdiv_rn"),
        "fast_div": _divisions(src, "__fdividef"),
        "no_hue": _sub(src, "if (jit.hue) shift_hue(v, fh);", ""),
        "apply_occ": _sub(src, "kApplyBlocks = C == 1 && COUT == 3 ? 3 : 4;",
                          "kApplyBlocks = 3;"),
        "no_combine": _sub(_sub(src, "  cluster.sync();\n  if (rank == 0 && tid == 0) {",
                                "  if (rank == 0 && tid == 0) {"),
                           "for (int i = 1; i < cl; ++i) combine(",
                           "for (int i = 1; i < 1; ++i) combine("),
        "no_math": _sub(src, "      const int e0 = first[u];\n",
                        "      const int e0 = first[u];\n"
                        "      if (e0 > INT_MIN) {\n"
                        "        const uint4 v = *reinterpret_cast<const uint4*>(&vals[u]);\n"
                        "        diff |= v.x ^ v.y ^ v.z ^ v.w;\n"
                        "        continue;\n"
                        "      }\n"),
        "stats_occ": _sub(src, "kStatsBlocks = 8;", "kStatsBlocks = 4;"),
        "whole_image": _sub(_sub(src, "rb = want_mean ? 0 : wr0, re = want_mean ? h : wr1;",
                                 "rb = 0, re = h;"),
                            "ps = want_mean ? 0 : we0, pe = want_mean ? row_len : we1;",
                            "ps = 0, pe = row_len;"),
    }


def _build_all(sources: dict, out_dir) -> dict:
    """Every variant into its own library, one nvcc each, all started
    together; returns {variant: (library path, ptxas log)}."""
    from eoe_tpu_torch.ops import _build

    def build(name):
        cu, so = out_dir / f"augment-{name}.cu", out_dir / f"augment-{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"augment_variants.py: {name} failed to build:\n{proc.stderr[-3000:]}")
        return name, (so, proc.stdout + proc.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(build, sources))


def _inputs(cs, name: str, dtype: str):
    """One half-batch of the stack's crop step, made as
    ``chip_smoke.phase_augment`` makes it."""
    import torch
    from eoe_tpu_torch.ops import augment as A
    from eoe_tpu_torch.ops import preprocess as P
    st = cs.AUG_STACKS[name]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    size, pad = (st["size"],) * 2, st["padding"]
    x = cs._aug_images(g, st, dtype)
    d = P.draw_random_crop(x, g, size=size, padding=pad)
    flip = P.draw_random_hflip(x, g)["flip"]
    cs._zero_window(x, d["tops"], d["lefts"], flip, st["flip_first"], st["size"], pad, 6)
    jitter = None
    if st["jitter"]:
        jitter = P.draw_color_jitter(P._to_float(x), g, **dict.fromkeys(A.JITTER, st["jitter"]))
    noise = torch.randn(cs.BATCH, *size, 3, generator=g, device="cuda") if st["noise"] else None
    norm = (P.CLIP_MEAN, P.CLIP_STD) if st["norm"] == "clip" else st["norm"]
    contrast = jitter is not None
    skw = dict(size=size, padding=pad, flip_first=st["flip_first"], contrast=contrast,
               guard=st["guard"], brightness=jitter["brightness"] if contrast else None)
    akw = dict(size=size, padding=pad, flip_first=st["flip_first"], jitter=jitter, noise=noise,
               noise_std=st["noise"] or 0.0, norm=norm)
    return x, d["tops"], d["lefts"], flip, skw, akw, st["guard"] or contrast


def _time(cs, libs: dict, card: str):
    import torch
    from eoe_tpu_torch.ops import augment as A
    base_lib, geometry = libs["base"], A.stats_geometry
    threads, least = A.APPLY_THREADS, A.MIN_BLOCKS
    order = ["base", *APPLY_VARIANTS, *STATS_VARIANTS]
    order += order[::-1]
    rows = {}
    for stack, dtype in (("acceptance", "uint8"), ("wrn", "uint8"), ("cifar", "uint8"),
                         ("cifar", "float32")):
        x, tops, lefts, flip, skw, akw, stats = _inputs(cs, stack, dtype)
        A._library = lambda: base_lib
        ref = A.crop_stats(x, tops, lefts, flip, **skw) if stats else (None, None)
        out_ref = A.crop_apply(x, tops, lefts, flip, *ref, **akw)
        for name in order:
            kind = "stats" if name in STATS_VARIANTS else "apply"
            if kind == "stats" and not stats:
                continue
            A._library = lambda: libs.get(name, base_lib)
            A.APPLY_THREADS = threads // 2 if name == "half_rows" else threads
            A.MIN_BLOCKS = 0 if name == "full_rows" else least
            A.stats_geometry = {"cluster_1": lambda *a: 1,
                                "whole_image": lambda *a: geometry(*a[:-1], True)}.get(name,
                                                                                       geometry)
            if kind == "stats" or name == "base":
                got = A.crop_stats(x, tops, lefts, flip, **skw) if stats else (None, None)
                cs.check(name in INEXACT or all(a is None or torch.equal(a, b)
                                                for a, b in zip(got, ref)),
                         f"augment_variants {name} {stack}: the stats differ from the base's")
                if stats:
                    ms = cs.time_ms(lambda: A.crop_stats(x, tops, lefts, flip, **skw))
                    rows.setdefault((stack, dtype, "stats", name), []).append(ms)
            if kind == "apply":
                out = A.crop_apply(x, tops, lefts, flip, *ref, **akw)
                err = (out - out_ref).abs().max().item()
                cs.check(name in INEXACT or torch.equal(out, out_ref),
                         f"augment_variants {name} {stack}: apply differs by {err}")
                ms = cs.time_ms(lambda: A.crop_apply(x, tops, lefts, flip, *ref, **akw))
                rows.setdefault((stack, dtype, "apply", name), []).append(ms)
                if name in INEXACT:
                    rows[(stack, dtype, "apply", f"{name}_err")] = [err]
        A._library, A.stats_geometry = lambda: base_lib, geometry
        A.APPLY_THREADS, A.MIN_BLOCKS = threads, least
    for (stack, dtype, kernel, name), values in rows.items():
        print(f"variant {stack} {dtype} {kernel} {name}: "
              f"{' / '.join(f'{v:.4g}' for v in values)}{'' if 'err' in name else ' ms'} [{card}]")


def phase_only():
    import torch
    if not torch.cuda.is_available():
        sys.exit("augment_variants.py: torch.cuda.is_available() is false: it needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from eoe_tpu_torch.ops import _build, augment
    card = cs.phase_card()
    _build.build(augment.SOURCE)
    for line in cs.ptxas_summary(_build.build_log(augment.SOURCE)):
        print(f"ptxas {augment.SOURCE}: {line}")
    rows = cs.phase_augment(card)
    print(json.dumps({f"{s} {d}": {k: v for k, v in row.items() if isinstance(v, dict)}
                      for (s, d), row in rows.items()}))


def main():
    import ctypes
    import torch
    if not torch.cuda.is_available():
        sys.exit("augment_variants.py: torch.cuda.is_available() is false: it needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from eoe_tpu_torch.ops import _build, augment

    card = cs.phase_card()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    built = _build_all(variants((_build.CSRC_DIR / augment.SOURCE).read_text()), out_dir)
    libs = {}
    for name, (so, log) in built.items():
        for line in cs.ptxas_summary(log):
            print(f"ptxas augment {name}: {line}")
        libs[name] = augment.bind(ctypes.CDLL(str(so)))
    _time(cs, libs, card)


if __name__ == "__main__":
    phase_only() if sys.argv[1:] == ["--phase"] else main()
