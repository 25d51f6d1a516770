// Scaled dot-product attention over (n, h, S, d) with an optional additive
// (S, S) mask, for Hopper (sm_90a): the forward of flash_attention.
//
// It replaces the TPU kernel eoe_tpu/ops/attention.py::_kernel, reached there
// through _flash_forward and flash_attention, which CLIP(attention_fn=
// flash_attention) calls in every transformer block: the image tower at
// (n, 12, 50, 64) with no mask, the text tower at (n, 8, 77, 64) with the
// additive causal mask. Sequences up to 1024 (the JAX package's
// MAX_SINGLE_BLOCK; longer ones never reach a kernel there or here) and any
// head dim, as _flash_forward pads any d. Its backward is not a kernel in the
// JAX package either.
//
// Numerics follow _kernel: q and k in fp32, logits = (q.k) * d^-1/2 rounded
// once, then + mask; keys past S at -inf; an fp32 softmax with the row max
// subtracted; P = p / sum normalised BEFORE it is rounded to v's dtype; P.V
// accumulated in fp32 and cast to the output dtype. A row whose logits are
// all -inf gives NaN, as the JAX kernel does; a row with one finite logit is
// finite.
//
// The same source holds the long attention (ops/attention.py,
// long_qkv_attention), which the image tower of ViT-L/14 (s = 257) runs on
// the normal path: its forward is the tensor-core stream below under a name
// of its own (long_fwd_kernel), which also writes each row's max and sum of
// exp; its backward is a pair of kernels of its own (see "the long
// attention's backward").
//
// Layout: q, k, v and out are read and written through their own (n, h, s)
// strides with d contiguous, so the caller passes the head-split views of a
// joint projection as they are and gets its output back in (n, s, h, d)
// memory without a copy.
//
// What bounds it on this card: it moves 4*n*h*S*d elements (q, k, v read
// once, the output written once) plus the 4*S^2 mask bytes, and does
// 4*n*h*S^2*d operations: about 16 operations per byte at CLIP's S=50 in
// bf16, far under the ~295 at which the tensor cores would be the limit, so
// it is bound by bytes; at S=1024 (~250 per byte) nearly by operations.
// The launcher picks one of three variants by dtype, shape and alignment
// (never by a failed launch) and reports it to the caller:
//   - tensor cores (bf16, d <= 128 a multiple of 8, every base pointer and
//     stride a multiple of 16 bytes, as CLIP's head-split views are): the
//     fused-QKV kernels' bf16 design, cp.async 16-byte tile loads, every
//     product mma.sync m16n8k16 bf16 -> fp32 from ldmatrix, the fp32 softmax
//     in the accumulator registers and P packed from them into P.V's A
//     operand; d padded with zero columns to 32, 64 or 128. S <= 128: one
//     block per (image, head), a warp per 16 query rows, K and V staged once.
//     128 < S <= 1024: blocks of 64 query rows, K and V streamed in 64-key
//     tiles through a two-buffer cp.async ring, and two passes (row max and
//     sum online, then the logits again for P.V), since P is normalised
//     before it is rounded;
//   - fp32 register tiles (fp32, d <= 128 a multiple of 4, 16-byte rows), on
//     the fp32 register tiles of common.cuh (each shared load feeds 4 or more
//     FMAs): S <= 128 runs the fused fp32 forward's per-head function, one
//     block per (image, head), the whole sequence resident; above, the
//     tensor-core variant's two-pass stream;
//   - CUDA cores (every other shape: d above 128 or ragged, unaligned views):
//     one block per (n*h, 32 query rows), 8 warps of 4 rows; q in fp32 in
//     shared memory; K, then V, staged 32 keys at a time; the logits of the
//     block's rows kept in shared memory (128 KB at S=1024), so P is
//     normalised from them directly; d above 256 walked in chunks of 256
//     columns (the chunks' partial q.k summed in fp32 in the logit rows,
//     scaled and masked after the last chunk; one chunk is the single-pass
//     arithmetic).

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace eoe;

constexpr int kMaxSeq = 1024;                 // MAX_SINGLE_BLOCK

// Element strides of one tensor's n, h and s axes; d is contiguous.
struct Strides {
  long long n, h, s;
};

struct Layout {
  Strides q, k, v, out;
};

// The variant a call took, as the launcher reports it.
enum Variant { kCudaCores = 0, kTensorCores = 1, kRegisterTiles = 2 };

// ---------------------------------------------------------------- the logit of every variant

// The mask term of row r and key j: the fp32 mask read through L2 (one
// (S, S) array for every image and head), 0 without a mask and for padded
// query rows (r >= s, as _flash_forward zeroes their mask rows; they are
// never stored).
__device__ __forceinline__ float flash_mask(const float* __restrict__ mask, int s, int r, int key) {
  return mask != nullptr && r < s && key < s ? __ldg(mask + (size_t)r * s + key) : 0.f;
}

// _kernel's logit from the product q.k and the mask term: scaled once, then
// the mask added; keys past s are -inf.
__device__ __forceinline__ float flash_logit(float qk, float scale, float mask, int s, int key) {
  return key < s ? __fadd_rn(__fmul_rn(qk, scale), mask) : -INFINITY;
}

// The base against which a tile's exps join a row's running max m and sum
// l, given the tile's max mt: the new max, or 0 while no finite logit has
// come (every exp is then 0 and l stays 0). Once every tile is in, a row
// whose logits are all -inf has m = -inf and l = 0, and its P is NaN, as in
// _kernel.
__device__ __forceinline__ float online_base(float m, float mt) {
  const float mn = fmaxf(m, mt);
  return mn == -INFINITY ? 0.f : mn;
}

// P is normalised in fp32 by a row's normaliser, the reciprocal of its sum,
// taken once: one rounding more than _kernel's division, at most an ulp of P
// before it is rounded to the element type, and far cheaper than an IEEE
// division per key (attention_variants.py, "divide", measures it).
__device__ __forceinline__ float flash_norm(float l) {
  return 1.f / l;
}

// P of one logit from the row's final max and normaliser.
__device__ __forceinline__ float flash_prob(float x, float m, float n) {
  return expf(__fsub_rn(x, m)) * n;
}

// ---------------------------------------------------------------- bf16 on tensor cores

// Padded head dim of the tensor-core and register-tiled variants: d <= D,
// the columns past d zero-filled in shared memory and never stored.
template <int D>
struct TcDims {
  static constexpr int kPitch = D + 8;   // bf16 rows padded by 16 bytes, as the fused kernels
};

// The mask terms of a warp's fragments (rows r_lo and r_lo + 8, keys
// key0 + 8 nt + 2 (lane % 4) .. +1), read in a pass of their own so that
// their loads through L2 go out together, not one by one between the
// logits' arithmetic. Read before QK^T instead of after it, they gain
// nothing and take registers (attention_variants.py, "mask_early").
template <int NTILES>
__device__ __forceinline__ void tc_mask(float (&mk)[NTILES][4], int key0, int r_lo,
                                        const float* __restrict__ mask, int s) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + nt * 8 + 2 * (lane % 4) + e;
      mk[nt][e] = flash_mask(mask, s, r_lo, key);
      mk[nt][2 + e] = flash_mask(mask, s, r_lo + 8, key);
    }
  }
}

// The scaled, masked logits of a warp's fragments (as tc_mask's), and their
// row maxima over the quad.
template <int NTILES>
__device__ __forceinline__ void tc_logits(float (&x)[NTILES][4], const float (&mk)[NTILES][4],
                                          int key0, float scale, int s, float& m_lo,
                                          float& m_hi) {
  const int lane = threadIdx.x % 32;
  m_lo = m_hi = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + nt * 8 + 2 * (lane % 4) + e;
      x[nt][e] = flash_logit(x[nt][e], scale, mk[nt][e], s, key);
      x[nt][2 + e] = flash_logit(x[nt][2 + e], scale, mk[nt][2 + e], s, key);
      m_lo = fmaxf(m_lo, x[nt][e]);
      m_hi = fmaxf(m_hi, x[nt][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
}

// The sums of exp(x - base) of a warp's two fragment rows over the quad.
template <int NTILES>
__device__ __forceinline__ void tc_sum_exp(const float (&x)[NTILES][4], float base_lo,
                                           float base_hi, float& s_lo, float& s_hi) {
  s_lo = s_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s_lo += expf(__fsub_rn(x[nt][e], base_lo));
      s_hi += expf(__fsub_rn(x[nt][2 + e], base_hi));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
    s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
  }
}

// P of the fragments, normalised in fp32 and rounded to bf16, packed as the
// A operand of P.V (one fragment per 16 keys); n_lo and n_hi are the rows'
// normalisers.
template <int K16>
__device__ __forceinline__ void tc_probs(uint32_t (&p)[K16][4], const float (&x)[2 * K16][4],
                                         float m_lo, float n_lo, float m_hi, float n_hi) {
#pragma unroll
  for (int t = 0; t < K16; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float (&f)[4] = x[2 * t + h];
      p[t][2 * h] = pack_bf16(flash_prob(f[0], m_lo, n_lo), flash_prob(f[1], m_lo, n_lo));
      p[t][2 * h + 1] = pack_bf16(flash_prob(f[2], m_hi, n_hi), flash_prob(f[3], m_hi, n_hi));
    }
  }
}

// Store a warp's 16 x D fp32 fragments as bf16 through its 16 rows of
// `stage` (pitch D + 8), then rows [row0, row0 + 16) below s, columns below
// d, in 16-byte chunks to dst + row * row_stride.
template <int D>
__device__ __forceinline__ void tc_store_rows(const float (&o)[D / 8][4], bf16* stage, bf16* dst,
                                              long long row_stride, int row0, int s, int d) {
  constexpr int P = TcDims<D>::kPitch;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + g * P + nt * 8 + c2) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * P + nt * 8 + c2) =
        pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < s && c * 8 < d)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
  }
}

// S <= 128: the whole sequence, padded to 16 * KT rows, in one block per
// (image, head) with QW = KT warps of 16 query rows; K and V are staged
// once for all of them. (QW < KT splits the rows over KT / QW blocks, each
// staging K and V again: attention_variants.py measures that.)
template <int D, int KT, int QW>
__global__ void __launch_bounds__(32 * QW)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const float* __restrict__ mask, bf16* __restrict__ out, Layout lay, int heads,
                int s, int d, float scale) {
  constexpr int P = TcDims<D>::kPitch, R = 16 * KT, NT = 32 * QW;
  extern __shared__ __align__(16) uint32_t smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // 16 * QW query rows
  bf16* Ks = Qs + 16 * QW * P;                    // R key rows
  bf16* Vs = Ks + R * P;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * 16 * QW;           // the block's first query row
  const bf16* qb = q + b * lay.q.n + h * lay.q.h;
  tile_load<bf16, D, P, NT>(Qs, qb + q0 * lay.q.s, lay.q.s, 16 * QW, s - q0, d);
  tile_load<bf16, D, P, NT>(Ks, k + b * lay.k.n + h * lay.k.h, lay.k.s, R, s, d);
  cp_async_commit();
  tile_load<bf16, D, P, NT>(Vs, v + b * lay.v.n + h * lay.v.h, lay.v.s, R, s, d);
  cp_async_commit();
  cp_async_wait<1>();                  // Q and K have landed; V may still be in flight
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32 * 16;        // the warp's rows in the block
  const int r_lo = q0 + row0 + lane / 4;
  float x[2 * KT][4], mk[2 * KT][4];
  mma_abt<D, KT, P>(x, Qs + row0 * P, Ks);
  tc_mask<2 * KT>(mk, 0, r_lo, mask, s);
  float m_lo, m_hi, l_lo, l_hi;
  tc_logits<2 * KT>(x, mk, 0, scale, s, m_lo, m_hi);
  tc_sum_exp<2 * KT>(x, m_lo, m_hi, l_lo, l_hi);
  uint32_t p[KT][4];
  tc_probs<KT>(p, x, m_lo, flash_norm(l_lo), m_hi, flash_norm(l_hi));
  cp_async_wait<0>();
  __syncthreads();
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  mma_av<D, KT, P>(o, p, Vs);
  // the warp's own Q rows are free now: stage the output there
  tc_store_rows<D>(o, Qs + row0 * P, out + b * lay.out.n + h * lay.out.h, lay.out.s, q0 + row0,
                   s, d);
}

// 128 < S <= 1024: blocks of kTcRows query rows (a warp per 16), K and V
// streamed through shared memory in tiles of kKeyTile keys, two buffers
// each, the next tile's cp.async in flight while the current one is used.
// P is normalised before it is rounded, so the final row max and sum must
// be known before any P.V: pass 1 takes them online over the key tiles
// (scalars only), pass 2 recomputes each tile's logits, forms the rounded P
// and accumulates P.V.
constexpr int kTcRows = 64;
constexpr int kKeyTile = 64;

// Runs body(t, buffer) for the key tiles t < n_tiles after load(t, buffer)
// has landed, with load(t + 1, the other buffer) in flight meanwhile. Every
// thread of the block calls it; commit groups before it must have been
// committed (they are waited for with the first tile).
template <typename Load, typename Body>
__device__ __forceinline__ void for_each_tile(int n_tiles, Load load, Body body) {
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(t, t & 1);
    __syncthreads();                   // the buffer is refilled with tile t + 2
  }
}

// The grid is one-dimensional, the query tiles of one (image, head) next to
// each other, so that the blocks streaming the same K and V run together and
// find them in L2. With `stats`, each row's final max and sum of exp (pass 1's
// m and l, from which pass 2 forms P) go to stats[(b * heads + h) * s + row]:
// the long attention's backward recomputes P from them.
template <int D>
__device__ __forceinline__ void flash_tc_stream(const bf16* __restrict__ q,
                                                const bf16* __restrict__ k,
                                                const bf16* __restrict__ v,
                                                const float* __restrict__ mask,
                                                bf16* __restrict__ out, float2* __restrict__ stats,
                                                const Layout& lay, int heads, int s, int d,
                                                float scale) {
  constexpr int P = TcDims<D>::kPitch, NT = 2 * kTcRows, NB = kKeyTile / 16;
  extern __shared__ __align__(16) uint32_t smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // kTcRows query rows
  bf16* Ks = Qs + kTcRows * P;                    // two tiles of kKeyTile keys
  bf16* Vs = Ks + 2 * kKeyTile * P;
  const int q_tiles = (s + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x % q_tiles * kTcRows;
  const bf16* kb = k + b * lay.k.n + h * lay.k.h;
  const bf16* vb = v + b * lay.v.n + h * lay.v.h;
  tile_load<bf16, D, P, NT>(Qs, q + b * lay.q.n + h * lay.q.h + q0 * lay.q.s, lay.q.s,
                            kTcRows, s - q0, d);
  cp_async_commit();
  const int n_tiles = (s + kKeyTile - 1) / kKeyTile;
  auto load_k = [&](int t, int buf) {
    tile_load<bf16, D, P, NT>(Ks + buf * kKeyTile * P, kb + t * kKeyTile * lay.k.s, lay.k.s,
                              kKeyTile, s - t * kKeyTile, d);
  };
  auto load_v = [&](int t, int buf) {
    tile_load<bf16, D, P, NT>(Vs + buf * kKeyTile * P, vb + t * kKeyTile * lay.v.s, lay.v.s,
                              kKeyTile, s - t * kKeyTile, d);
  };
  auto load_kv = [&](int t, int buf) {
    load_k(t, buf);
    load_v(t, buf);
  };

  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32 * 16;
  const int r_lo = q0 + row0 + lane / 4;
  const bf16* qw = Qs + row0 * P;

  // ---- pass 1: the rows' max and sum of exp, online over the key tiles
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for_each_tile(n_tiles, load_k, [&](int t, int buf) {
    float x[2 * NB][4], mk[2 * NB][4], mt_lo, mt_hi, s_lo, s_hi;
    mma_abt<D, NB, P>(x, qw, Ks + buf * kKeyTile * P);
    tc_mask<2 * NB>(mk, t * kKeyTile, r_lo, mask, s);
    tc_logits<2 * NB>(x, mk, t * kKeyTile, scale, s, mt_lo, mt_hi);
    const float base_lo = online_base(m_lo, mt_lo), base_hi = online_base(m_hi, mt_hi);
    tc_sum_exp<2 * NB>(x, base_lo, base_hi, s_lo, s_hi);
    l_lo = l_lo * expf(__fsub_rn(m_lo, base_lo)) + s_lo;
    l_hi = l_hi * expf(__fsub_rn(m_hi, base_hi)) + s_hi;
    m_lo = fmaxf(m_lo, mt_lo);
    m_hi = fmaxf(m_hi, mt_hi);
  });

  if (stats != nullptr && lane % 4 == 0) {
    float2* st = stats + (size_t)bh * s;
    if (r_lo < s) st[r_lo] = make_float2(m_lo, l_lo);
    if (r_lo + 8 < s) st[r_lo + 8] = make_float2(m_hi, l_hi);
  }

  // ---- pass 2: the logits again, P rounded, P.V
  const float n_lo = flash_norm(l_lo), n_hi = flash_norm(l_hi);
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  for_each_tile(n_tiles, load_kv, [&](int t, int buf) {
    float x[2 * NB][4], mk[2 * NB][4], mt_lo, mt_hi;
    mma_abt<D, NB, P>(x, qw, Ks + buf * kKeyTile * P);
    tc_mask<2 * NB>(mk, t * kKeyTile, r_lo, mask, s);
    tc_logits<2 * NB>(x, mk, t * kKeyTile, scale, s, mt_lo, mt_hi);
    uint32_t p[NB][4];
    tc_probs<NB>(p, x, m_lo, n_lo, m_hi, n_hi);
    mma_av<D, NB, P>(o, p, Vs + buf * kKeyTile * P);
  });
  tc_store_rows<D>(o, Qs + row0 * P, out + b * lay.out.n + h * lay.out.h, lay.out.s, q0 + row0,
                   s, d);
}

// flash_attention's stream: a mask, no statistics.
template <int D>
__global__ void __launch_bounds__(2 * kTcRows)
flash_tc_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ mask,
                       bf16* __restrict__ out, Layout lay, int heads, int s, int d, float scale) {
  flash_tc_stream<D>(q, k, v, mask, out, nullptr, lay, heads, s, d, scale);
}

// The long attention's forward: the same stream over the joint projection's
// views, no mask, the statistics written. A kernel of its own name, so that
// a trace tells it from flash_attention's.
template <int D>
__global__ void __launch_bounds__(2 * kTcRows)
long_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float2* __restrict__ stats,
                Layout lay, int heads, int s, float scale) {
  flash_tc_stream<D>(q, k, v, nullptr, out, stats, lay, heads, s, D, scale);
}

// ---------------------------------------------------------------- the long attention's backward
//
// The backward of long_qkv_attention (ops/attention.py): bf16 on the tensor
// cores, d in (64, 128), no mask, 128 < S <= 1024, in the FlashAttention-2
// order. The forward (long_fwd_kernel: the stream on the head-split views of
// the joint projection) saved each row's max m and sum l; with n = 1 / l, P is
// recomputed tile by tile as the forward's pass 2 forms it,
// P = exp(x - m) * n with x = (q.k) * d^-1/2, and rounded to bf16 where it
// multiplies (dV = round(P)^T . dO). dP = dO . V^T; dS = P * (dP - delta)
// with the fp32 P and delta = rowsum(dO * O) in fp32, rounded to bf16 for
// dQ = dS . K * d^-1/2 and dK = dS^T . Q * d^-1/2. No atomics: two kernels,
// each output row written by one block, so that two runs give the same bits.
//   long_bwd_dq_kernel: a block per 64 query rows (a warp per 16), K and V
//     streamed in 64-key tiles; it also writes delta for the second kernel;
//   long_bwd_dkdv_kernel: a block per 64 key rows (a warp per 16, which
//     holds dK and dV of its rows in registers), Q, dO and the rows' m, n
//     and delta streamed in 64-query tiles; S^T = K . Q^T and
//     dP^T = V . dO^T are formed key-major, so that P^T and dS^T pass from
//     the accumulators into the A operands of dV and dK without shared
//     memory.
// Both write into one (n, S, 3 H d) d(qkv) laid out as the projection: dQ,
// dK and dV in its three column blocks.
//
// What bounds it: it reads qkv, O, dO and writes d(qkv) (9 H d elements a
// row, 7 of them compulsory) and does 5 products of 2 S^2 d operations an
// (image, head) once, plus QK^T and dP again in the second kernel: at
// S = 257, d = 64 about 60 operations a byte, under the ~295 at which the
// tensor cores would be the limit.

constexpr int kBwdRows = 64;    // the rows a block owns: a warp per 16
constexpr int kBwdTile = 64;    // the other side's rows, streamed a tile at a time

// Query (or key) rows of 16 * NC at a time within a streamed tile: D = 128
// takes 32, so that two accumulators of 16 x 128 and the products' tiles
// stay in registers.
template <int D>
struct BwdChunk {
  static constexpr int kTiles = D == 64 ? 4 : 2;   // n-tiles of 16 in a chunk
  static constexpr int kRows = 16 * kTiles;
};

template <int D>
constexpr size_t long_bwd_smem() {
  return (size_t)6 * kBwdRows * TcDims<D>::kPitch * sizeof(bf16) +
         (size_t)2 * kBwdTile * sizeof(float4);
}

template <int D>
__global__ void __launch_bounds__(2 * kBwdRows)
long_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                   const bf16* __restrict__ dout, const float2* __restrict__ stats,
                   float* __restrict__ delta, bf16* __restrict__ dqkv, int heads, int s,
                   float scale) {
  constexpr int P = TcDims<D>::kPitch, NT = 2 * kBwdRows;
  constexpr int NK = BwdChunk<D>::kTiles, KC = BwdChunk<D>::kRows;
  extern __shared__ __align__(16) uint32_t smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // the block's query rows
  bf16* Gs = Qs + kBwdRows * P;                   // their dO rows
  bf16* Ks = Gs + kBwdRows * P;                   // two tiles of keys
  bf16* Vs = Ks + 2 * kBwdTile * P;
  const int q_tiles = (s + kBwdRows - 1) / kBwdRows;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x % q_tiles * kBwdRows;
  const int width = heads * D;
  const long long row = 3LL * width;
  const bf16* qb = qkv + (long long)b * s * row + h * D;     // q of row 0; k, v width apart
  const long long ob = (long long)b * s * width + h * D;     // row 0 of O and dO
  tile_load<bf16, D, P, NT>(Qs, qb + q0 * row, row, kBwdRows, s - q0, D);
  tile_load<bf16, D, P, NT>(Gs, dout + ob + (long long)q0 * width, width, kBwdRows, s - q0, D);
  cp_async_commit();
  const int n_tiles = (s + kBwdTile - 1) / kBwdTile;
  auto load_kv = [&](int t, int buf) {
    const bf16* src = qb + (long long)t * kBwdTile * row;
    tile_load<bf16, D, P, NT>(Ks + buf * kBwdTile * P, src + width, row, kBwdTile,
                              s - t * kBwdTile, D);
    tile_load<bf16, D, P, NT>(Vs + buf * kBwdTile * P, src + 2 * width, row, kBwdTile,
                              s - t * kBwdTile, D);
  };

  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32 * 16;
  const int g = lane / 4;
  const int r_lo = q0 + row0 + g, r_hi = r_lo + 8;

  // delta of the warp's 16 rows: two lanes a row, half the columns each,
  // straight from O and dO in global memory; written for the dK/dV kernel
  float dl;
  {
    const int r = q0 + row0 + lane / 2, c0 = lane % 2 * (D / 2);
    float acc = 0.f;
    if (r < s) {
      const uint4* o4 = reinterpret_cast<const uint4*>(out + ob + (long long)r * width + c0);
      const uint4* g4 = reinterpret_cast<const uint4*>(dout + ob + (long long)r * width + c0);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = o4[c], gv = g4[c];
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(to_f32(oe[e]), to_f32(ge[e]), acc);
      }
    }
    dl = acc + __shfl_xor_sync(0xffffffffu, acc, 1);
    if (r < s && lane % 2 == 0) delta[(size_t)bh * s + r] = dl;
  }
  const float dl_lo = __shfl_sync(0xffffffffu, dl, 2 * g);
  const float dl_hi = __shfl_sync(0xffffffffu, dl, 2 * g + 16);
  // the rows' m and n = 1 / l; padding rows take n = 0, so their P is 0
  float m_lo = 0.f, n_lo = 0.f, m_hi = 0.f, n_hi = 0.f;
  if (r_lo < s) {
    const float2 st = stats[(size_t)bh * s + r_lo];
    m_lo = st.x, n_lo = flash_norm(st.y);
  }
  if (r_hi < s) {
    const float2 st = stats[(size_t)bh * s + r_hi];
    m_hi = st.x, n_hi = flash_norm(st.y);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  for_each_tile(n_tiles, load_kv, [&](int t, int buf) {
#pragma unroll
    for (int c = 0; c < kBwdTile / KC; ++c) {
      const bf16* kt = Ks + (buf * kBwdTile + c * KC) * P;
      const bf16* vt = Vs + (buf * kBwdTile + c * KC) * P;
      float x[2 * NK][4], dp[2 * NK][4];
      mma_abt<D, NK, P>(x, Qs + row0 * P, kt);       // S = Q . K^T
      mma_abt<D, NK, P>(dp, Gs + row0 * P, vt);      // dP = dO . V^T
      uint32_t ds[NK][4];                            // round(dS) as the A operand of dS . K
#pragma unroll
      for (int nt = 0; nt < 2 * NK; ++nt) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * kBwdTile + c * KC + nt * 8 + 2 * (lane % 4) + (e & 1);
          const float p = key < s ? flash_prob(__fmul_rn(x[nt][e], scale), e < 2 ? m_lo : m_hi,
                                               e < 2 ? n_lo : n_hi)
                                  : 0.f;
          d[e] = __fmul_rn(p, __fsub_rn(dp[nt][e], e < 2 ? dl_lo : dl_hi));
        }
        ds[nt / 2][(nt % 2) * 2] = pack_bf16(d[0], d[1]);
        ds[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      mma_av<D, NK, P>(acc, ds, kt);                 // dQ += dS . K
    }
  });
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] *= scale;
  // the warp's own Q rows are free now: stage dQ there
  tc_store_rows<D>(acc, Qs + row0 * P, dqkv + (long long)b * s * row + h * D, row, q0 + row0,
                   s, D);
}

template <int D>
__global__ void __launch_bounds__(2 * kBwdRows)
long_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     const float2* __restrict__ stats, const float* __restrict__ delta,
                     bf16* __restrict__ dqkv, int heads, int s, float scale) {
  constexpr int P = TcDims<D>::kPitch, NT = 2 * kBwdRows;
  constexpr int NQ = BwdChunk<D>::kTiles, QC = BwdChunk<D>::kRows;
  extern __shared__ __align__(16) uint32_t smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);   // the block's key rows
  bf16* Vs = Ks + kBwdRows * P;
  bf16* Qs = Vs + kBwdRows * P;                   // two tiles of queries
  bf16* Gs = Qs + 2 * kBwdTile * P;               // and of their dO rows
  float4* Ls = reinterpret_cast<float4*>(Gs + 2 * kBwdTile * P);   // (m, n, delta) a query
  const int k_tiles = (s + kBwdRows - 1) / kBwdRows;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x % k_tiles * kBwdRows;
  const int width = heads * D;
  const long long row = 3LL * width;
  const bf16* qb = qkv + (long long)b * s * row + h * D;
  const bf16* gb = dout + (long long)b * s * width + h * D;
  tile_load<bf16, D, P, NT>(Ks, qb + width + k0 * row, row, kBwdRows, s - k0, D);
  tile_load<bf16, D, P, NT>(Vs, qb + 2 * width + k0 * row, row, kBwdRows, s - k0, D);
  cp_async_commit();
  const int n_tiles = (s + kBwdTile - 1) / kBwdTile;
  auto load_q = [&](int t, int buf) {
    const int r0 = t * kBwdTile;
    tile_load<bf16, D, P, NT>(Qs + buf * kBwdTile * P, qb + r0 * row, row, kBwdTile, s - r0, D);
    tile_load<bf16, D, P, NT>(Gs + buf * kBwdTile * P, gb + (long long)r0 * width, width,
                              kBwdTile, s - r0, D);
    // padding rows take n = 0: their P, and so their dS, is 0
    for (int i = threadIdx.x; i < kBwdTile; i += NT) {
      const int r = r0 + i;
      float4 l = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < s) {
        const float2 st = stats[(size_t)bh * s + r];
        l = make_float4(st.x, flash_norm(st.y), delta[(size_t)bh * s + r], 0.f);
      }
      Ls[buf * kBwdTile + i] = l;
    }
  };

  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32 * 16;
  float dv[D / 8][4], dk[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[t][e] = dk[t][e] = 0.f;
  for_each_tile(n_tiles, load_q, [&](int t, int buf) {
#pragma unroll
    for (int c = 0; c < kBwdTile / QC; ++c) {
      const bf16* qt = Qs + (buf * kBwdTile + c * QC) * P;
      const bf16* gt = Gs + (buf * kBwdTile + c * QC) * P;
      const float4* lt = Ls + buf * kBwdTile + c * QC;
      float x[2 * NQ][4], dp[2 * NQ][4];
      mma_abt<D, NQ, P>(x, Ks + row0 * P, qt);       // S^T = K . Q^T
      mma_abt<D, NQ, P>(dp, Vs + row0 * P, gt);      // dP^T = V . dO^T
      uint32_t pt[NQ][4], dst[NQ][4];                // round(P^T), round(dS^T) as A operands
#pragma unroll
      for (int nt = 0; nt < 2 * NQ; ++nt) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 l = lt[nt * 8 + 2 * (lane % 4) + (e & 1)];   // the column's query
          p[e] = flash_prob(__fmul_rn(x[nt][e], scale), l.x, l.y);
          d[e] = __fmul_rn(p[e], __fsub_rn(dp[nt][e], l.z));
        }
        pt[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
        pt[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dst[nt / 2][(nt % 2) * 2] = pack_bf16(d[0], d[1]);
        dst[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      mma_av<D, NQ, P>(dv, pt, gt);                  // dV += P^T . dO
      mma_av<D, NQ, P>(dk, dst, qt);                 // dK += dS^T . Q
    }
  });
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] *= scale;
  // the warp's own K and V rows are free now: stage dK and dV there
  bf16* dst = dqkv + (long long)b * s * row + h * D;
  tc_store_rows<D>(dk, Ks + row0 * P, dst + width, row, k0 + row0, s, D);
  tc_store_rows<D>(dv, Vs + row0 * P, dst + 2 * width, row, k0 + row0, s, D);
}

template <int D>
cudaError_t launch_long_bwd(const bf16* qkv, const bf16* out, const bf16* dout,
                            const float2* stats, float* delta, bf16* dqkv, int n, int heads,
                            int s, float scale, cudaStream_t st) {
  static std::atomic<bool> raised_dq[kMaxDevices], raised_dkdv[kMaxDevices];
  constexpr size_t smem = long_bwd_smem<D>();
  cudaError_t err = allow_smem(long_bwd_dq_kernel<D>, smem, smem, raised_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(long_bwd_dkdv_kernel<D>, smem, smem, raised_dkdv);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n * heads * ((s + kBwdRows - 1) / kBwdRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  long_bwd_dq_kernel<D><<<(unsigned)blocks, 2 * kBwdRows, smem, st>>>(
      qkv, out, dout, stats, delta, dqkv, heads, s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long_bwd_dkdv_kernel<D><<<(unsigned)blocks, 2 * kBwdRows, smem, st>>>(
      qkv, dout, stats, delta, dqkv, heads, s, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 on register tiles

constexpr int kTileWarps = 8;

// fp32, S <= 128: the fused fp32 forward's per-head function (common.cuh),
// one block per (image, head), the whole sequence resident, each warp taking
// quads of query rows; keys past S at -inf, the mask added.
template <int D>
__global__ void __launch_bounds__(32 * kTileWarps)
flash_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  float* __restrict__ out, Layout lay, int heads, int s, int d, float scale) {
  extern __shared__ __align__(16) uint32_t smem_f32[];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  f32_attend_head<D, 32 * kTileWarps>(
      q + b * lay.q.n + h * lay.q.h, lay.q.s, k + b * lay.k.n + h * lay.k.h, lay.k.s,
      v + b * lay.v.n + h * lay.v.h, lay.v.s, out + b * lay.out.n + h * lay.out.h, lay.out.s, s,
      d, false,
      [&](int r, int key, float qk) {
        return flash_logit(qk, scale, flash_mask(mask, s, r, key), s, key);
      },
      smem_f32);
}

// fp32, 128 < S <= 1024: blocks of kTileRows = 64 query rows, 8 warps of two
// quads of rows each (rows 4w .. 4w + 3 and 32 + 4w .. 32 + 4w + 3 of the
// block); K and V in tiles of kKeyTile keys through the same two-buffer ring
// and the same two passes as the tensor-core stream, the products on the
// register tiles of common.cuh.
constexpr int kTileRows = 2 * 4 * kTileWarps;   // two quads a warp

template <int D>
__global__ void __launch_bounds__(32 * kTileWarps)
flash_tile_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ mask,
                         float* __restrict__ out, Layout lay, int heads, int s, int d,
                         float scale) {
  constexpr int P = F32Tile<D>::kPitch, NT = 32 * kTileWarps, NC = kKeyTile / 32;
  extern __shared__ __align__(16) uint32_t smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Ks = Qs + kTileRows * P;
  float* Vs = Ks + 2 * kKeyTile * P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* pw = reinterpret_cast<float4*>(Vs + 2 * kKeyTile * P) + warp * kKeyTile;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTileRows;
  const float* kb = k + b * lay.k.n + h * lay.k.h;
  const float* vb = v + b * lay.v.n + h * lay.v.h;
  tile_load<float, D, P, NT>(Qs, q + b * lay.q.n + h * lay.q.h + q0 * lay.q.s, lay.q.s,
                             kTileRows, s - q0, d);
  cp_async_commit();
  const int n_tiles = (s + kKeyTile - 1) / kKeyTile;
  auto load_k = [&](int t, int buf) {
    tile_load<float, D, P, NT>(Ks + buf * kKeyTile * P, kb + t * kKeyTile * lay.k.s, lay.k.s,
                               kKeyTile, s - t * kKeyTile, d);
  };
  auto load_kv = [&](int t, int buf) {
    load_k(t, buf);
    tile_load<float, D, P, NT>(Vs + buf * kKeyTile * P, vb + t * kKeyTile * lay.v.s, lay.v.s,
                               kKeyTile, s - t * kKeyTile, d);
  };

  const int rq[2] = {4 * warp, 4 * (kTileWarps + warp)};   // the quads' first rows in the block
  // logits of quad i against key tile t (in buffer buf), and the tile's key count
  auto logits = [&](float (&x)[4][NC], int i, int t, int buf) {
    const int keys = min(kKeyTile, s - t * kKeyTile);
    f32_qk<D, NC>(x, Qs + rq[i] * P, Ks + buf * kKeyTile * P, (keys + 31) / 32);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = t * kKeyTile + lane + 32 * c;
        x[r][c] = flash_logit(x[r][c], scale, flash_mask(mask, s, q0 + rq[i] + r, key), s, key);
      }
    return keys;
  };

  // ---- pass 1: the rows' max and sum of exp, online over the key tiles
  float m[2][4], l[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[i][r] = -INFINITY, l[i][r] = 0.f;
  for_each_tile(n_tiles, load_k, [&](int t, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (q0 + rq[i] >= s) continue;             // a quad of padding rows only
      float x[4][NC];
      logits(x, i, t, buf);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int c = 0; c < NC; ++c) mt = fmaxf(mt, x[r][c]);
        mt = warp_max(mt);
        const float base = online_base(m[i][r], mt);
        float se = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) se += expf(__fsub_rn(x[r][c], base));
        l[i][r] = l[i][r] * expf(__fsub_rn(m[i][r], base)) + warp_sum(se);
        m[i][r] = fmaxf(m[i][r], mt);
      }
    }
  });

  // ---- pass 2: the logits again, P through the warp's float4 row, P.V
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) l[i][r] = flash_norm(l[i][r]);
  float acc[2][4][D / 32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < D / 32; ++u) acc[i][r][u] = 0.f;
  for_each_tile(n_tiles, load_kv, [&](int t, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (q0 + rq[i] >= s) continue;
      float x[4][NC];
      const int keys = logits(x, i, t, buf);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        pw[lane + 32 * c] = make_float4(
            flash_prob(x[0][c], m[i][0], l[i][0]), flash_prob(x[1][c], m[i][1], l[i][1]),
            flash_prob(x[2][c], m[i][2], l[i][2]), flash_prob(x[3][c], m[i][3], l[i][3]));
      __syncwarp();
      f32_pv<D>(acc[i], pw, Vs + buf * kKeyTile * P, keys);
      __syncwarp();                    // pw is rewritten for the next quad
    }
  });
  float* ob = out + b * lay.out.n + h * lay.out.h;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (q0 + rq[i] + r < s) f32_store_row<D>(ob + (q0 + rq[i] + r) * lay.out.s, acc[i][r], d);
}

// ---------------------------------------------------------------- on CUDA cores, any shape

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile: one per lane

// NC = 32-column chunks of the head dim in shared memory: d <= 32 * NC, or
// NC = 8 and the head dim walked in chunks of 256 columns.
template <int NC>
struct Dims {
  static constexpr int kDim = NC * 32;     // padded head dim of the shared tiles
  static constexpr int kPitch = kDim + 4;  // K/V tile row, floats: 16-byte rows, no conflicts
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int NC>
size_t smem_bytes(int s) {
  using Dm = Dims<NC>;
  return ((size_t)kRows * Dm::kDim + (size_t)kKeys * Dm::kPitch +
          (size_t)kRows * round_up(s, kKeys)) * sizeof(float);
}

// Stage rows [key0, key0 + kKeys) of one head's k or v (columns from src,
// d of them left in this chunk), converted to fp32 and zero-padded (keys past
// s, columns past d), into a shared tile.
template <typename T, int NC>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          long long row_stride, int key0, int s, int d) {
  using Dm = Dims<NC>;
  for (int i = threadIdx.x; i < kKeys * Dm::kDim; i += kThreads) {
    const int j = i / Dm::kDim;
    const int c = i % Dm::kDim;
    const int key = key0 + j;
    tile[j * Dm::kPitch + c] = key < s && c < d ? to_f32(src[key * row_stride + c]) : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mask, T* __restrict__ out, Layout lay, int heads,
                 int s, int d, float scale) {
  using Dm = Dims<NC>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // kRows x kDim
  float* KV = Qs + kRows * Dm::kDim;             // kKeys x kPitch: a K, then a V, tile
  float* L = KV + kKeys * Dm::kPitch;            // kRows x s_pad: logits, then P
  const int s_pad = round_up(s, kKeys);
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + b * lay.q.n + h * lay.q.h;
  const T* kb = k + b * lay.k.n + h * lay.k.h;
  const T* vb = v + b * lay.v.n + h * lay.v.h;
  T* ob = out + b * lay.out.n + h * lay.out.h;

  const int r_first = warp * kRowsPerWarp;  // the warp's rows in the block
  const float4* q4 = reinterpret_cast<const float4*>(Qs + r_first * Dm::kDim);

  // ---- pass 1: logits (+ mask) of the warp's rows, one key per lane, summed
  //      over the head dim's chunks
  for (int c0 = 0; c0 < d; c0 += Dm::kDim) {
    const bool last = c0 + Dm::kDim >= d;
    if (c0 > 0) __syncthreads();  // the previous chunk's last tile is still being read
    // the block's query rows, this chunk's columns, fp32, zero-padded
    for (int i = threadIdx.x; i < kRows * Dm::kDim; i += kThreads) {
      const int r = row0 + i / Dm::kDim;
      const int c = i % Dm::kDim;
      Qs[i] = r < s && c0 + c < d ? to_f32(qb[r * lay.q.s + c0 + c]) : 0.f;
    }
    for (int key0 = 0; key0 < s; key0 += kKeys) {
      __syncthreads();  // the tile is free (and, the first time, Qs is written)
      load_tile<T, NC>(KV, kb + c0, lay.k.s, key0, s, d - c0);
      __syncthreads();
      const float4* k4 = reinterpret_cast<const float4*>(KV + lane * Dm::kPitch);
      float acc[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0.f;
#pragma unroll 4
      for (int c = 0; c < Dm::kDim / 4; ++c) {
        const float4 kk = k4[c];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float4 qq = q4[rr * (Dm::kDim / 4) + c];   // the same word for all lanes
          acc[rr] = fmaf(qq.x, kk.x, acc[rr]);
          acc[rr] = fmaf(qq.y, kk.y, acc[rr]);
          acc[rr] = fmaf(qq.z, kk.z, acc[rr]);
          acc[rr] = fmaf(qq.w, kk.w, acc[rr]);
        }
      }
      const int key = key0 + lane;
      if (key < s) {
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int r = min(row0 + r_first + rr, s - 1);  // rows past s are computed, not kept
          float* at = L + (r_first + rr) * s_pad + key;    // this lane's own word
          float logit = c0 > 0 ? __fadd_rn(*at, acc[rr]) : acc[rr];
          if (last) {
            logit = __fmul_rn(logit, scale);              // scaled once, then masked
            if (mask != nullptr) logit = __fadd_rn(logit, mask[(size_t)r * s + key]);
          }
          *at = logit;
        }
      }
    }
  }
  __syncwarp();

  // softmax of each row from its stored logits, normalised, rounded to v's dtype
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    float* Lr = L + (r_first + rr) * s_pad;
    float m = -INFINITY;
    for (int j = lane; j < s; j += 32) m = fmaxf(m, Lr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < s; j += 32) sum += expf(__fsub_rn(Lr[j], m));
    sum = warp_sum(sum);
    for (int j = lane; j < s; j += 32)
      Lr[j] = round_to<T>(__fdiv_rn(expf(__fsub_rn(Lr[j], m)), sum));
  }
  __syncwarp();

  // ---- pass 2: P.V, lane owns output columns lane, lane + 32, ... of the chunk
  for (int c0 = 0; c0 < d; c0 += Dm::kDim) {
    float acc[kRowsPerWarp][NC];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
    for (int key0 = 0; key0 < s; key0 += kKeys) {
      __syncthreads();
      load_tile<T, NC>(KV, vb + c0, lay.v.s, key0, s, d - c0);
      __syncthreads();
      const int keys = min(kKeys, s - key0);
      for (int j = 0; j < keys; ++j) {
        float vv[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) vv[i] = KV[j * Dm::kPitch + lane + 32 * i];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float p = L[(r_first + rr) * s_pad + key0 + j];   // the same word for all lanes
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[rr][i] = fmaf(p, vv[i], acc[rr][i]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + r_first + rr;
      if (r >= s) continue;
      T* o = ob + r * lay.out.s + c0;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c0 + c < d) o[c] = from_f32<T>(acc[rr][i]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask, void* out,
                   const Layout& lay, int n, int heads, int s, int d, float scale,
                   cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  auto kernel = flash_fwd_kernel<T, NC>;
  const size_t smem = smem_bytes<NC>(s);
  cudaError_t err = allow_smem(kernel, smem, smem_bytes<NC>(kMaxSeq), raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(n * heads, (s + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), mask, static_cast<T*>(out),
                                           lay, heads, s, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v, const float* mask,
                           void* out, const Layout& lay, int n, int heads, int s, int d,
                           float scale, cudaStream_t st) {
  if (d <= 32) return launch<T, 1>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  if (d <= 64) return launch<T, 2>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  if (d <= 128) return launch<T, 4>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  return launch<T, 8>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);   // chunks of 256
}


// ---------------------------------------------------------------- launchers

// Calls fn(integral_constant<D>) with the padded head dim of d <= 128.
template <typename Fn>
cudaError_t with_dim(int d, Fn fn) {
  if (d <= 32) return fn(std::integral_constant<int, 32>{});
  if (d <= 64) return fn(std::integral_constant<int, 64>{});
  return fn(std::integral_constant<int, 128>{});
}

// 128 < S: the two-pass stream, flash_attention's (`stats` null) or the long
// attention's forward (`stats` given, no mask, d = D).
template <int D>
cudaError_t launch_stream(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                          bf16* out, float2* stats, const Layout& lay, int n, int heads, int s,
                          int d, float scale, cudaStream_t st) {
  static std::atomic<bool> raised_flash[kMaxDevices], raised_long[kMaxDevices];
  constexpr size_t smem = (size_t)(kTcRows + 4 * kKeyTile) * TcDims<D>::kPitch * sizeof(bf16);
  cudaError_t err = stats == nullptr
                        ? allow_smem(flash_tc_stream_kernel<D>, smem, smem, raised_flash)
                        : allow_smem(long_fwd_kernel<D>, smem, smem, raised_long);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n * heads * ((s + kTcRows - 1) / kTcRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (stats == nullptr)
    flash_tc_stream_kernel<D><<<(unsigned)blocks, 2 * kTcRows, smem, st>>>(q, k, v, mask, out,
                                                                            lay, heads, s, d,
                                                                            scale);
  else
    long_fwd_kernel<D><<<(unsigned)blocks, 2 * kTcRows, smem, st>>>(q, k, v, out, stats, lay,
                                                                     heads, s, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* mask, void* out,
                      const Layout& lay, int n, int heads, int s, int d, float scale,
                      cudaStream_t st) {
  auto args = [&](auto kernel, dim3 grid, int threads, size_t smem) {
    kernel<<<grid, threads, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), mask, static_cast<bf16*>(out),
                                        lay, heads, s, d, scale);
    return cudaGetLastError();
  };
  return with_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    constexpr int P = TcDims<D>::kPitch;
    if (s > 128)
      return launch_stream<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), nullptr,
                              lay, n, heads, s, d, scale, st);
    auto small = [&](auto tiles) {
      constexpr int KT = decltype(tiles)::value;   // the sequence padded to 16 * KT rows
      constexpr int QW = KT;                       // warps of 16 query rows a block
      static std::atomic<bool> raised[kMaxDevices];
      auto kernel = flash_tc_kernel<D, KT, QW>;
      constexpr size_t smem = (size_t)(16 * QW + 32 * KT) * P * sizeof(bf16);
      cudaError_t err = allow_smem(kernel, smem, smem, raised);
      if (err != cudaSuccess) return err;
      return args(kernel, dim3(n * heads, (s + 16 * QW - 1) / (16 * QW)), 32 * QW, smem);
    };
    if (s <= 32) return small(std::integral_constant<int, 2>{});
    if (s <= 64) return small(std::integral_constant<int, 4>{});
    if (s <= 80) return small(std::integral_constant<int, 5>{});
    return small(std::integral_constant<int, 8>{});
  });
}

cudaError_t launch_tiles(const void* q, const void* k, const void* v, const float* mask,
                         void* out, const Layout& lay, int n, int heads, int s, int d,
                         float scale, cudaStream_t st) {
  auto args = [&](auto kernel, dim3 grid, size_t smem) {
    kernel<<<grid, 32 * kTileWarps, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(out), lay, heads, s, d, scale);
    return cudaGetLastError();
  };
  return with_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if (s <= 128) {
      static std::atomic<bool> raised[kMaxDevices];
      auto kernel = flash_tile_kernel<D>;
      const size_t smem = f32_head_smem<D, 32 * kTileWarps>(s);
      cudaError_t err = allow_smem(kernel, smem, f32_head_smem<D, 32 * kTileWarps>(128), raised);
      if (err != cudaSuccess) return err;
      return args(kernel, dim3(n * heads), smem);
    }
    static std::atomic<bool> raised[kMaxDevices];
    auto kernel = flash_tile_stream_kernel<D>;
    constexpr size_t smem = (size_t)(kTileRows + 4 * kKeyTile) * F32Tile<D>::kPitch *
                                sizeof(float) +
                            (size_t)kTileWarps * kKeyTile * sizeof(float4);
    cudaError_t err = allow_smem(kernel, smem, smem, raised);
    if (err != cudaSuccess) return err;
    return args(kernel, dim3(n * heads, (s + kTileRows - 1) / kTileRows), smem);
  });
}

// The variant for a call: the tensor cores (bf16) or the register tiles
// (fp32) when d <= 128 is a whole number of 16-byte chunks and every row of
// q, k, v and out starts on 16 bytes; the CUDA cores otherwise.
Variant choose(const void* const (&ptrs)[4], const Layout& lay, int d, int dtype) {
  const int chunk = dtype == 0 ? 4 : 8;      // elements of 16 bytes
  if (d > 128 || d % chunk != 0) return kCudaCores;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return kCudaCores;
  for (const Strides& st : {lay.q, lay.k, lay.v, lay.out})
    if (st.n % chunk != 0 || st.h % chunk != 0 || st.s % chunk != 0) return kCudaCores;
  return dtype == 0 ? kRegisterTiles : kTensorCores;
}

}  // namespace

// q, k, v, out: (n, heads, s, d) with element strides strides[0..2] (q),
// [3..5] (k), [6..8] (v), [9..11] (out) for the n, h and s axes and d
// contiguous; mask: a contiguous fp32 (s, s) array or null. dtype: 0 =
// float32, 1 = bfloat16, the same for q, k, v and out. Writes the variant it
// launched to *variant (0: CUDA cores, 1: tensor cores, 2: fp32 register
// tiles). Returns a cudaError_t (0 on success), launches on `stream`, which
// must belong to the current device (the caller sets it), and does not
// synchronise.
extern "C" int eoe_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, int n, int heads, int s,
                                       int d, int dtype, const long long* strides, float scale,
                                       void* stream, int* variant) {
  if (n < 1 || heads < 1 || s < 1 || s > kMaxSeq || d < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Layout lay{{strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                   {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Variant which = choose({q, k, v, out}, lay, d, dtype);
  *variant = which;
  if (which == kTensorCores)
    return (int)launch_tc(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  if (which == kRegisterTiles)
    return (int)launch_tiles(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  if (dtype == 0)
    return (int)launch_for_dim<float>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  return (int)launch_for_dim<bf16>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
}

// The long attention (ops/attention.py, long_qkv_attention): bf16 only, no
// mask, d = 64 or 128, 128 < s <= 1024; qkv (n, s, 3 * heads * d) laid out
// [q | k | v] with heads contiguous inside each, 16-byte aligned. The
// forward writes out (n, s, heads * d) and stats (n, heads, s) float2, each
// row's max and sum of exp; the backward takes qkv, out, dout (n, s,
// heads * d), stats and a scratch delta (n, heads, s) float, and writes
// dqkv (n, s, 3 * heads * d); scale is d^-1/2. Return a cudaError_t (0 on
// success); launch on `stream`, which must belong to the current device; do
// not synchronise.
static bool long_shape_ok(int n, int heads, int s, int d) {
  return n >= 1 && heads >= 1 && s > 128 && s <= kMaxSeq && (d == 64 || d == 128);
}

extern "C" int eoe_long_attention_fwd(const void* qkv, void* out, void* stats, int n, int heads,
                                      int s, int d, float scale, void* stream) {
  if (!long_shape_ok(n, heads, s, d)) return (int)cudaErrorInvalidValue;
  const long long row = 3LL * heads * d, width = (long long)heads * d;
  const Strides in{s * row, d, row};
  const Layout lay{in, in, in, {s * width, d, width}};
  const bf16* q = static_cast<const bf16*>(qkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return launch_stream<D>(q, q + width, q + 2 * width, nullptr, static_cast<bf16*>(out),
                            static_cast<float2*>(stats), lay, n, heads, s, d, scale, st);
  };
  return (int)(d == 64 ? run(std::integral_constant<int, 64>{})
                       : run(std::integral_constant<int, 128>{}));
}

extern "C" int eoe_long_attention_bwd(const void* qkv, const void* out, const void* dout,
                                      const void* stats, void* delta, void* dqkv, int n,
                                      int heads, int s, int d, float scale, void* stream) {
  if (!long_shape_ok(n, heads, s, d)) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
                  static_cast<const bf16*>(dout), static_cast<const float2*>(stats),
                  static_cast<float*>(delta), static_cast<bf16*>(dqkv), n, heads, s, scale,
                  static_cast<cudaStream_t>(stream));
  };
  return (int)(d == 64 ? args(launch_long_bwd<64>) : args(launch_long_bwd<128>));
}
