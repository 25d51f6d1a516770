// Fused QKV multi-head self-attention for Hopper (sm_90a): the forward and its
// backward, each on two grids.
//
// The forward replaces the TPU kernel eoe_tpu/ops/attention.py::_fwd_compute
// (with _fwd_group_math and _cell_bias), the backward replaces
// eoe_tpu/ops/attention.py::_bwd_compute (with _bwd_group_math); both are
// reached there through fused_qkv_attention and its custom_vjp. The same two
// kernels on the lane-group grid replace _fwd_group_compute and
// _bwd_group_compute, which the JAX package runs instead under
// EOE_TPU_ATTN_GROUP_GRID=1: one block per (image, 128-lane group of heads),
// that is two heads at d=64 and one at d=128, each block reading only its
// group's q, k, v (and dout) columns; the backward writes dq, dk and dv into
// the three column blocks of one packed d(qkv), as _group_grid_call's
// concatenation leaves them. The per-head code is the same on both grids
// (fwd_head_f32, fwd_head_tc, bwd_head_f32, bwd_head_tc), so the two grids
// give the same bits; a group's heads run one after the other in its block.
// Both CLIP
// encoders run every transformer block through the forward: the image side at
// s=50, 12 heads, d=64 with no mask, the text side at s=77, 8 heads, d=64,
// causal. Training runs the image side's backward through the second kernel.
//
// Input is the un-transposed joint projection qkv (n, s, 3*H*d), columns
// ordered [q | k | v] with heads contiguous inside each; the forward's output
// is (n, s, H*d) with heads concatenated, and the backward takes dout of that
// shape and writes d(qkv) (n, s, 3*H*d) packed [dq | dk | dv]. Nothing is
// transposed, padded or copied in HBM: a block loads its head's rows strided
// straight from qkv and dout.
//
// Forward numerics follow _fwd_group_math: logits in fp32 times d^-1/2 (for
// d=64 the TPU kernel pre-scales q by 2^-3 in the input dtype, which is exact,
// so the product is the same), masked keys at -1e30, fp32 softmax, P rounded to
// the input dtype before P.V, P.V accumulated in fp32 and cast to the input
// dtype.
//
// Backward numerics follow _bwd_group_math: P recomputed in fp32 as the
// forward does; dv = round(P).dout; dp = dout.v^T in fp32;
// dS = (dp - rowsum(dp*P)) * P with the fp32 P, rounded to the input dtype
// before dq = dS.k and dk = dS^T.q, all accumulated in fp32. The d^-1/2 scale
// sits where the TPU kernel puts it: inside dS for d=128, on dq and dk after
// the products for d=64.
//
// What bounds them on this card: at CLIP's shapes the forward moves
// n*s*4*H*d elements (read qkv once, write the output once) and does
// 4*n*H*s^2*d operations; the backward moves 7*n*s*H*d elements (read qkv and
// dout, write dqkv) and does 10*n*H*s^2*d. Both are about 25 operations per
// byte in bf16, far under the ~295 the H100 needs before its tensor cores are
// the limit: they are bound by bytes. The element type picks one of two
// designs (see with_tiles):
//
// bf16: tensor cores and asynchronous copies. A design on CUDA cores is held
// back long before the bytes: one shared-memory load per FMA caps it at the
// shared-memory instruction rate (bf16 was no faster than fp32 there). So:
//   - one block per (image, head) with one warp per 16 query rows; the
//     sequence is padded to 16 * KT rows (KT in {2, 4, 5, 8}: s=50 -> 64,
//     s=77 -> 80, s <= 128), padded rows of q, k, v and dout are zero-filled
//     in shared memory (never left as they are: 0 x NaN garbage is NaN),
//     padded keys masked to -1e30 as _cell_bias does, padded rows not stored;
//   - tiles come in by cp.async.cg 16-byte copies strided straight from qkv
//     and dout, in two commit groups: (Q, K) first, then V (and dout), so that
//     the second group lands while QK^T and the softmax run. Overlap across
//     (image, head) items comes from several resident blocks per SM. Rows are
//     padded by 16 bytes so that ldmatrix's eight 16-byte rows hit eight bank
//     groups; the wrapper checks that qkv and dout are 16-byte aligned;
//   - every product is mma.sync m16n8k16 bf16 -> fp32, operands through
//     ldmatrix (.trans where the product contracts over the row axis). The
//     fp32 logits stay in the accumulator registers for the softmax (row max
//     and sum through quad shuffles); P is normalised in fp32, rounded to
//     bf16 and packed straight into the A operand of P.V (the C -> A reuse
//     of FlashAttention-2). Outputs go through the warp's own rows of shared
//     memory and out as 16-byte stores, dq as 4-byte pairs;
//   - the backward takes 5 products, not 7: step 1, per warp of 16 query
//     rows, S = QK^T and dP = dout.V^T, the fp32 P and
//     dS = (dP - rowsum(dP*P)) * P in registers (rowsum from the fp32 P, as
//     _bwd_group_math), round(P) and round(dS) once, dq = round(dS).K, and
//     both rounded tiles into shared memory; step 2, after one barrier, per
//     warp of 16 key rows, dv = round(P)^T.dout and dk = round(dS)^T.Q. No
//     recompute, no atomics, nothing depends on block order.
// Sums run in the tensor core's order, so bf16 results are no longer bit for
// bit those of the plain version; they hold to the same tolerances.
//
// fp32: CUDA-core FMAs, since fp32 is what the parity runs hold the port to
// and what fp32 serving runs, and a tensor-core fp32 product would be TF32, a
// different function. The first designs (a warp per row) spent one
// shared-memory load on every FMA. Both directions now take the register
// tiles of common.cuh: one block per (image, head), tiles copied in by
// cp.async 16-byte pieces into rows padded to D + 4 floats (so the wrapper
// checks 16-byte alignment in fp32 too), a warp per four rows (the quads
// round-robin over the warps), lane l owning keys l, l + 32, ... of a QK^T-like
// product and D/32 adjacent output columns of a P.V-like one, so that a float4
// read of K feeds 16 FMAs and one broadcast float4 of P and a float2 or
// float4 of V feed 8 or 16. Numerics as the plain versions but for one
// rounding: fp32 logits times d^-1/2, masked and padded keys at -1e30, fp32
// softmax, P normalised by the sum's reciprocal (the plain versions divide:
// at most an ulp of P), products summed in order. The flash kernel's fp32
// variant runs the forward's per-head function.
//
// The fp32 backward (bwd_head_f32) takes 5 products, as bf16 does. Step 1,
// per quad of query rows: S = QK^T and dP = dout.V^T by the same helper with
// other operands, the softmax, rowsum(dP*P) and dS by warp shuffles,
// dq = dS.K through the warp's float4 buffer of dS by key, and P and dS into
// shared memory laid out [key / 4][query][4]; step 2, after one barrier, per
// quad of key rows, dv = P^T.dout and dk = dS^T.Q, each reading one float4 of
// its four keys per query row. No atomics; nothing depends on block order.
// Four tiles and the two (query, key) tables take 108.5 KB at CLIP's image
// shape (two blocks a SM) and fit one block up to s=96 at d=64 and s=64 at
// d=128 (kResident). Longer sequences keep only K and V while step 1 reads
// each quad's q and dout rows from global memory (through L1), then load Q and
// dout in their place; the tables give way to each row's max, reciprocal sum
// and rowsum(dP*P), and step 2 recomputes S^T and dP^T from global quads of k
// and v rows with the same operations, so P and dS have step 1's bits
// (kRecompute, 7 products). The launcher reports the design it took.

#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace eoe;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;                 // one tile covers the sequence
constexpr int kLane = 128;                   // the TPU kernel's lane group
constexpr float kMasked = -1e30f;            // the TPU kernel's additive bias
constexpr size_t kMaxSmem = 227 * 1024;      // dynamic shared memory of one block

// The fp32 forward of one (image b, head h), by the whole block, on the
// register tiles of common.cuh: masked and padded keys at -1e30.
template <int D>
__device__ __forceinline__ void fwd_head_f32(const float* __restrict__ qkv,
                                             float* __restrict__ out, uint32_t* smem, int b,
                                             int h, int s, int heads, int causal, float scale) {
  const int width = heads * D;
  const float* src = qkv + (size_t)b * s * 3 * width + h * D;   // q of row 0, head h
  f32_attend_head<D, kThreads>(
      src, 3 * width, src + width, 3 * width, src + 2 * width, 3 * width,
      out + (size_t)b * s * width + h * D, width, s, D, causal,
      [&](int r, int key, float qk) {
        return key < (causal ? min(r + 1, s) : s) ? qk * scale : kMasked;
      },
      smem);
}

// ---------------------------------------------------------------- bf16 on tensor cores

// One head's tiles for a sequence padded to 16 * KT rows: rows of D elements
// padded by 16 bytes (kPitch), and the (query, key) tiles of P and dS
// (kPPitch), so that the eight rows of an ldmatrix hit eight bank groups.
template <int D, int KT>
struct TcTile {
  static constexpr int kRows = 16 * KT;
  static constexpr int kPitch = D + 8;
  static constexpr int kElems = kRows * kPitch;
  static constexpr int kPPitch = kRows + 8;
  static constexpr int kThreads = 32 * KT;     // a warp per 16 rows
};

template <int D, int KT>
constexpr size_t tc_fwd_smem() { return (size_t)3 * TcTile<D, KT>::kElems * sizeof(bf16); }

template <int D, int KT>
constexpr size_t tc_bwd_smem() {
  using Tl = TcTile<D, KT>;
  return ((size_t)4 * Tl::kElems + (size_t)2 * Tl::kRows * Tl::kPPitch) * sizeof(bf16);
}

// The A fragments of one 16-row tile of x^T, for x a (rows, 16 cols) slice
// of a (query, key) tile at x (pitch kPPitch): rows 16t .. 16t + 15 of x
// become the contraction axis.
template <int D, int KT>
__device__ __forceinline__ void tc_at_frag(uint32_t (&a)[4], const bf16* x, int t) {
  constexpr int P = TcTile<D, KT>::kPPitch;
  const int lane = threadIdx.x % 32;
  const int m = lane / 8;                           // which 8x8 matrix this lane addresses
  ldsm_x4_t(a, smem_addr(x + (t * 16 + lane % 8 + (m / 2) * 8) * P + (m % 2) * 8));
}

// Store a warp's 16 x D fp32 fragments as bf16 (times `mul`) into its 16
// rows of `stage` (pitch kPitch), then copy rows [row0, s) out in 16-byte
// chunks to dst + row * row_elems.
template <int D, int KT>
__device__ __forceinline__ void tc_store_staged(const float (&acc)[D / 8][4], float mul,
                                                bf16* stage, bf16* dst, size_t row_elems,
                                                int row0, int s) {
  constexpr int P = TcTile<D, KT>::kPitch;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + g * P + nt * 8 + c2) =
        pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * P + nt * 8 + c2) =
        pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    if (row0 + r < s)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * row_elems + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * P + c * 8);
  }
}

// Scale and mask the warp's fp32 logits (rows row0 + g and row0 + g + 8,
// keys 8 nt + 2 (lane % 4) .. +1) and turn them into the fp32 softmax in
// place: masked and padded keys at -1e30 (exp gives 0), max and sum over the
// row's quad.
template <int KT>
__device__ __forceinline__ void tc_softmax(float (&x)[2 * KT][4], int row0, int s, int causal,
                                           float scale) {
  const int lane = threadIdx.x % 32;
  const int r_lo = row0 + lane / 4, r_hi = r_lo + 8;
  float m_lo = kMasked, m_hi = kMasked;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = nt * 8 + 2 * (lane % 4) + e;
      const bool ok_lo = key < s && (!causal || key <= r_lo);
      const bool ok_hi = key < s && (!causal || key <= r_hi);
      x[nt][e] = ok_lo ? x[nt][e] * scale : kMasked;
      x[nt][2 + e] = ok_hi ? x[nt][2 + e] * scale : kMasked;
      m_lo = fmaxf(m_lo, x[nt][e]);
      m_hi = fmaxf(m_hi, x[nt][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[nt][e] = expf(x[nt][e] - m_lo);
      x[nt][2 + e] = expf(x[nt][2 + e] - m_hi);
      sum_lo += x[nt][e];
      sum_hi += x[nt][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
  }
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    x[nt][0] = x[nt][0] / sum_lo;
    x[nt][1] = x[nt][1] / sum_lo;
    x[nt][2] = x[nt][2] / sum_hi;
    x[nt][3] = x[nt][3] / sum_hi;
  }
}

// The forward of one (image b, head h) in bf16, by the whole block: warp w
// owns query rows 16w .. 16w + 15.
template <int D, int KT>
__device__ __forceinline__ void fwd_head_tc(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                            uint32_t* smem, int b, int h, int s, int heads,
                                            int causal, float scale) {
  using Tl = TcTile<D, KT>;
  const int width = heads * D;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + Tl::kElems;
  bf16* Vs = Ks + Tl::kElems;
  const bf16* src = qkv + (size_t)b * s * 3 * width + h * D;   // q of row 0, head h
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Qs, src, 3 * width, Tl::kRows, s, D);
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Ks, src + width, 3 * width, Tl::kRows, s, D);
  cp_async_commit();
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Vs, src + 2 * width, 3 * width, Tl::kRows, s, D);
  cp_async_commit();
  cp_async_wait<1>();                  // Q and K have landed; V may still be in flight
  __syncthreads();

  const int row0 = threadIdx.x / 32 * 16;
  float x[2 * KT][4];
  mma_abt<D, KT, Tl::kPitch>(x, Qs + row0 * Tl::kPitch, Ks);
  tc_softmax<KT>(x, row0, s, causal, scale);
  uint32_t p[KT][4];                   // round(P) as the A operand of P.V
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    p[t][0] = pack_bf16(x[2 * t][0], x[2 * t][1]);
    p[t][1] = pack_bf16(x[2 * t][2], x[2 * t][3]);
    p[t][2] = pack_bf16(x[2 * t + 1][0], x[2 * t + 1][1]);
    p[t][3] = pack_bf16(x[2 * t + 1][2], x[2 * t + 1][3]);
  }
  cp_async_wait<0>();
  __syncthreads();
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  mma_av<D, KT, Tl::kPitch>(o, p, Vs);
  // the warp's own Q rows are free now: stage the output there
  tc_store_staged<D, KT>(o, 1.f, Qs + row0 * Tl::kPitch, out + (size_t)b * s * width + h * D,
                         width, row0, s);
}

// One block per (image, group of PER heads), the heads of a group one after
// the other. PER=1 is the monolithic grid of _fwd_compute; PER=128/D is the
// lane-group grid of _fwd_group_compute (two heads at d=64, one at d=128).
template <int D, int PER>
__global__ void __launch_bounds__(kThreads)
fused_qkv_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int s, int heads,
                     int causal, float scale) {
  extern __shared__ __align__(16) uint32_t smem_f32[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's tiles are still being read
    fwd_head_f32<D>(qkv, out, smem_f32, b, g * PER + i, s, heads, causal, scale);
  }
}

// The same grids in bf16, for a sequence padded to 16 * KT rows. The heads of
// a group stay a loop (unrolled, the two heads' code interleaves and spills).
template <int D, int PER, int KT>
__global__ void __launch_bounds__(TcTile<D, KT>::kThreads)
fused_qkv_fwd_kernel_tc(const bf16* __restrict__ qkv, bf16* __restrict__ out, int s, int heads,
                        int causal, float scale) {
  extern __shared__ __align__(16) uint32_t smem_tc[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll 1
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's tiles are still being read
    fwd_head_tc<D, KT>(qkv, out, smem_tc, b, g * PER + i, s, heads, causal, scale);
  }
}

// ---------------------------------------------------------------- fp32 backward

// The logit of (query r, key) as _bwd_group_math forms it: masked and padded
// keys at -1e30, the others q.k times d^-1/2. The explicit-rounding
// intrinsics here and below keep nvcc from contracting them into FMAs, so
// that P and dS recomputed from the same operands have the same bits.
__device__ __forceinline__ float bwd_logit(int r, int key, float qk, int s, int causal,
                                           float scale) {
  return key < (causal ? min(r + 1, s) : s) ? __fmul_rn(qk, scale) : kMasked;
}

// P of a logit from its row's max and reciprocal sum.
__device__ __forceinline__ float bwd_prob(float logit, float m, float inv) {
  return __fmul_rn(expf(__fsub_rn(logit, m)), inv);
}

// dS of one (row, key) pair from the fp32 P.
template <int D>
__device__ __forceinline__ float grad_logit(float dp, float rowsum, float p, float scale) {
  const float ds = __fmul_rn(__fsub_rn(dp, rowsum), p);
  return D == 128 ? __fmul_rn(ds, scale) : ds;   // d=64 scales dq and dk instead
}

// The backward's designs, as the launcher reports them: bf16 on the tensor
// cores, and the two fp32 designs by what stays in shared memory (rows: the
// sequence padded to a multiple of 32):
//   kResident   Q, K, V and dout, and the fp32 P and dS of every (query, key);
//   kRecompute  K and V in step 1, whose warps read their quads of q and dout
//               rows from global memory, then Q and dout in their place for
//               step 2, and each query row's max, reciprocal sum and
//               rowsum(dP*P); step 2 recomputes P and dS from them, reading
//               its quads of k and v rows from global.
// fp32 takes kResident where it fits one block (f32_bwd_design). The kernels
// take the design as an int, so that ptxas's report names it.
enum BwdDesign : int { kTensorCores, kResident, kRecompute };

// Floats of shared memory: the tiles (pitch D + 4), each warp's float4
// buffers of `rows` (one; two for kRecompute), then P and dS laid out
// [key / 4][query][4] with rows + 1 float4s per key quad (so that step 1's
// scalar stores of 32 keys hit 32 banks and step 2 reads one float4 of four
// keys per query row), or the row statistics.
template <int D>
constexpr size_t f32_bwd_floats(int rows, int how) {
  const size_t tiles = (size_t)(how == kResident ? 4 : 2) * rows * F32Tile<D>::kPitch;
  const size_t bufs = (size_t)(how == kRecompute ? 2 : 1) * kWarps * rows * 4;
  const size_t kept =
      how == kRecompute ? (size_t)3 * rows : (size_t)2 * (rows / 4) * (rows + 1) * 4;
  return tiles + bufs + kept;
}

template <int D>
BwdDesign f32_bwd_design(int s) {
  const int rows = (s + 31) / 32 * 32;
  return f32_bwd_floats<D>(rows, kResident) * sizeof(float) <= kMaxSmem ? kResident : kRecompute;
}

// The rows of a quad from row0 in global memory, `stride` floats apart from
// base, for f32_qk_rows; rows past s repeat row s - 1, so that nothing is
// read past the tensor (their results are never stored).
__device__ __forceinline__ auto quad_rows(const float* base, int row0, int s, int stride) {
  return [=](int i) { return base + (size_t)min(row0 + i, s - 1) * stride; };
}

// Scale a quad's accumulators by `mul` and store rows row0 + i < s at
// dst + row * out_row.
template <int D>
__device__ __forceinline__ void f32_store_quad(float (&acc)[4][D / 32], float mul, float* dst,
                                               int out_row, int row0, int s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < D / 32; ++u) acc[i][u] *= mul;
    if (row0 + i < s) f32_store_row<D>(dst + (size_t)(row0 + i) * out_row, acc[i], D);
  }
}

// The fp32 backward of one (image b, head h), by the whole block, on the
// register tiles of common.cuh. Row j of dq starts at
// dq + (b * s + j) * out_row + h * D, and so for dk and dv (the three column
// blocks of the packed d(qkv)). Step 1, per quad of query rows (round-robin
// over the warps): S = QK^T and dP = dout.V^T, the fp32 softmax (P normalised
// by the reciprocal sum), rowsum(dP*P) and dS by warp shuffles, dq = dS.K
// from the warp's buffer of dS by key; P and dS (or the row statistics) kept.
// Step 2, after one barrier, per quad of key rows: dv = P^T.dout and
// dk = dS^T.Q, over the query rows that see the keys. Five products, or seven
// with kRecompute; no atomics, nothing depends on block order.
template <int D, int How>
__device__ __forceinline__ void bwd_head_f32(const float* __restrict__ qkv,
                                             const float* __restrict__ dout,
                                             float* __restrict__ dq, float* __restrict__ dk,
                                             float* __restrict__ dv, int out_row, uint32_t* smem,
                                             int b, int h, int s, int heads, int causal,
                                             float scale) {
  constexpr int P = F32Tile<D>::kPitch, NC = kMaxSeq / 32, U = D / 32;
  const int width = heads * D, ld = 3 * width;
  const int rows = (s + 31) / 32 * 32;               // zero-filled past s
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = qkv + (size_t)b * s * ld + h * D;   // q of row 0, head h
  const float* gb = dout + (size_t)b * s * width + h * D;
  const size_t out_b = (size_t)b * s * out_row + h * D;
  const float mul = D == 64 ? scale : 1.f;           // d=64 scales dq and dk, d=128 dS

  constexpr int kTiles = How == kResident ? 4 : 2;
  float* T0 = reinterpret_cast<float*>(smem);
  float* Ks = How == kResident ? T0 + rows * P : T0;
  float* Vs = Ks + rows * P;
  float* Qs = T0;                                    // step 2's Q and dout: resident,
  float* Gs = How == kResident ? Vs + rows * P : Vs;  // or loaded over K and V
  float4* bufs = reinterpret_cast<float4*>(T0 + kTiles * rows * P);
  float4* wds = bufs + warp * rows;                  // dS by key (step 1), by query (step 2)
  float4* wp = bufs + (kWarps + warp) * rows;        // P by query (kRecompute, step 2)
  float* kept = reinterpret_cast<float*>(bufs + (How == kRecompute ? 2 : 1) * kWarps * rows);
  float4* Pt = reinterpret_cast<float4*>(kept);      // [key / 4][query], pitch rows + 1
  float4* St = Pt + rows / 4 * (rows + 1);
  float* stat_m = kept;                              // kRecompute: per query row
  float* stat_inv = stat_m + rows;
  float* stat_rs = stat_inv + rows;

  if constexpr (How == kResident) {
    tile_load<float, D, P, kThreads>(Qs, qb, ld, rows, s, D);
    tile_load<float, D, P, kThreads>(Gs, gb, width, rows, s, D);
  }
  tile_load<float, D, P, kThreads>(Ks, qb + width, ld, rows, s, D);
  tile_load<float, D, P, kThreads>(Vs, qb + 2 * width, ld, rows, s, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- step 1: per quad of query rows
  for (int r0 = 4 * warp; r0 < s; r0 += 4 * kWarps) {
    const int n_max = causal ? min(r0 + 4, s) : s;   // keys the quad's last row sees
    const int nch = (n_max + 31) / 32;               // uniform across the warp
    float x[4][NC], y[4][NC];                        // S, then P; dP, then dS
    if constexpr (How == kResident) {
      f32_qk<D, NC>(x, Qs + r0 * P, Ks, nch);
      f32_qk<D, NC>(y, Gs + r0 * P, Vs, nch);
    } else {
      f32_qk_rows<D, NC>(x, quad_rows(qb, r0, s, ld), Ks, nch);
      f32_qk_rows<D, NC>(y, quad_rows(gb, r0, s, width), Vs, nch);
    }
    float m[4], inv[4], rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[i][c] = bwd_logit(r0 + i, lane + 32 * c, x[i][c], s, causal, scale);
        m[i] = fmaxf(m[i], x[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = warp_max(m[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[i][c] = expf(__fsub_rn(x[i][c], m[i]));
        sum += x[i][c];
      }
      inv[i] = 1.f / warp_sum(sum);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[i][c] = __fmul_rn(x[i][c], inv[i]);        // bwd_prob's bits
        t = fmaf(y[i][c], x[i][c], t);
      }
      rs[i] = warp_sum(t);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) y[i][c] = grad_logit<D>(y[i][c], rs[i], x[i][c], scale);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nch) {
        const int key = lane + 32 * c;
        wds[key] = make_float4(y[0][c], y[1][c], y[2][c], y[3][c]);
        if constexpr (How == kResident) {
          float* pt = reinterpret_cast<float*>(Pt + key / 4 * (rows + 1) + r0) + key % 4;
          float* st = reinterpret_cast<float*>(St + key / 4 * (rows + 1) + r0) + key % 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) pt[4 * i] = x[i][c], st[4 * i] = y[i][c];
        }
      }
    }
    if constexpr (How == kRecompute) {
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          stat_m[r0 + i] = m[i], stat_inv[r0 + i] = inv[i], stat_rs[r0 + i] = rs[i];
      }
    }
    __syncwarp();
    float acc[4][U];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
    f32_pv<D>(acc, wds, Ks, n_max);                  // dq = dS . K
    f32_store_quad<D>(acc, mul, dq + out_b, out_row, r0, s);
    __syncwarp();  // wds is rewritten by this warp's next quad
  }
  __syncthreads();  // P and dS (or the statistics) complete; K and V are free

  if constexpr (How == kRecompute) {
    tile_load<float, D, P, kThreads>(Qs, qb, ld, rows, s, D);
    tile_load<float, D, P, kThreads>(Gs, gb, width, rows, s, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- step 2: per quad of key rows, over the query rows from r_lo
  const int nq = rows / 32;                          // chunks of query rows (kRecompute)
  for (int j0 = 4 * warp; j0 < s; j0 += 4 * kWarps) {
    const int r_lo = causal ? j0 : 0;                // first query row that sees key j0
    const float4 *pj, *dsj;                          // P and dS of the quad, by query row
    if constexpr (How == kRecompute) {
      float x[4][NC], y[4][NC];                      // S^T and dP^T: lane owns query rows
      f32_qk_rows<D, NC>(x, quad_rows(qb + width, j0, s, ld), Qs, nq);
      f32_qk_rows<D, NC>(y, quad_rows(qb + 2 * width, j0, s, ld), Gs, nq);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nq) {
          const int r = lane + 32 * c;
          const float mr = stat_m[r], ir = stat_inv[r], rr = stat_rs[r];
          float p[4], d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[i] = bwd_prob(bwd_logit(r, j0 + i, x[i][c], s, causal, scale), mr, ir);
            d[i] = grad_logit<D>(y[i][c], rr, p[i], scale);
          }
          wp[r] = make_float4(p[0], p[1], p[2], p[3]);
          wds[r] = make_float4(d[0], d[1], d[2], d[3]);
        }
      }
      __syncwarp();
      pj = wp + r_lo;
      dsj = wds + r_lo;
    } else {
      pj = Pt + j0 / 4 * (rows + 1) + r_lo;
      dsj = St + j0 / 4 * (rows + 1) + r_lo;
    }
    float acc[4][U];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
    f32_pv<D>(acc, pj, Gs + r_lo * P, s - r_lo);     // dv = P^T . dout
    f32_store_quad<D>(acc, 1.f, dv + out_b, out_row, j0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
    f32_pv<D>(acc, dsj, Qs + r_lo * P, s - r_lo);    // dk = dS^T . Q
    f32_store_quad<D>(acc, mul, dk + out_b, out_row, j0, s);
    if constexpr (How == kRecompute) __syncwarp();   // wp and wds are rewritten next
  }
}

// The backward of one (image b, head h) in bf16, by the whole block, with
// bwd_head_f32's output layout. Step 1: warp w owns query rows 16w .. 16w + 15;
// step 2: key rows 16w .. 16w + 15.
template <int D, int KT>
__device__ __forceinline__ void bwd_head_tc(const bf16* __restrict__ qkv,
                                            const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                                            int out_row, uint32_t* smem, int b, int h, int s,
                                            int heads, int causal, float scale) {
  using Tl = TcTile<D, KT>;
  const int width = heads * D;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + Tl::kElems;
  bf16* Vs = Ks + Tl::kElems;
  bf16* Gs = Vs + Tl::kElems;                      // dout
  bf16* Ps = Gs + Tl::kElems;                      // round(P), (query, key)
  bf16* Ds = Ps + Tl::kRows * Tl::kPPitch;         // round(dS), (query, key)
  const bf16* src = qkv + (size_t)b * s * 3 * width + h * D;
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Qs, src, 3 * width, Tl::kRows, s, D);
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Ks, src + width, 3 * width, Tl::kRows, s, D);
  cp_async_commit();
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Vs, src + 2 * width, 3 * width, Tl::kRows, s, D);
  tile_load<bf16, D, Tl::kPitch, Tl::kThreads>(Gs, dout + (size_t)b * s * width + h * D, width,
                                                Tl::kRows, s, D);
  cp_async_commit();
  cp_async_wait<1>();                  // Q and K have landed
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32 * 16;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const size_t out_b = (size_t)b * s * out_row + h * D;   // row 0 of image b, head h
  const float mul = D == 64 ? scale : 1.f;   // d=64 scales dq and dk, d=128 scales dS

  // ---- step 1: P and dS of the warp's query rows, dq
  float p[2 * KT][4], dp[2 * KT][4];
  mma_abt<D, KT, Tl::kPitch>(p, Qs + row0 * Tl::kPitch, Ks);
  tc_softmax<KT>(p, row0, s, causal, scale);       // the fp32 P
  cp_async_wait<0>();                  // V and dout have landed
  __syncthreads();
  mma_abt<D, KT, Tl::kPitch>(dp, Gs + row0 * Tl::kPitch, Vs);
  float rs_lo = 0.f, rs_hi = 0.f;                  // rowsum(dP * P), fp32 P
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    rs_lo += dp[nt][0] * p[nt][0] + dp[nt][1] * p[nt][1];
    rs_hi += dp[nt][2] * p[nt][2] + dp[nt][3] * p[nt][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, o);
    rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, o);
  }
  // padded query rows get P = dS = 0, so that they add nothing to dk and dv
  const bool real_lo = row0 + g < s, real_hi = row0 + g + 8 < s;
  uint32_t ds[KT][4];                              // round(dS) as the A operand of dS.K
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[e] = (dp[nt][e] - (e < 2 ? rs_lo : rs_hi)) * p[nt][e];
      if (D == 128) d[e] = d[e] * scale;
    }
    const uint32_t p_lo = real_lo ? pack_bf16(p[nt][0], p[nt][1]) : 0u;
    const uint32_t p_hi = real_hi ? pack_bf16(p[nt][2], p[nt][3]) : 0u;
    const uint32_t d_lo = real_lo ? pack_bf16(d[0], d[1]) : 0u;
    const uint32_t d_hi = real_hi ? pack_bf16(d[2], d[3]) : 0u;
    const int idx = (row0 + g) * Tl::kPPitch + nt * 8 + c2;
    *reinterpret_cast<uint32_t*>(Ps + idx) = p_lo;
    *reinterpret_cast<uint32_t*>(Ps + idx + 8 * Tl::kPPitch) = p_hi;
    *reinterpret_cast<uint32_t*>(Ds + idx) = d_lo;
    *reinterpret_cast<uint32_t*>(Ds + idx + 8 * Tl::kPPitch) = d_hi;
    ds[nt / 2][(nt % 2) * 2] = d_lo;
    ds[nt / 2][(nt % 2) * 2 + 1] = d_hi;
  }
  {
    float acc[D / 8][4];
#pragma unroll
    for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    mma_av<D, KT, Tl::kPitch>(acc, ds, Ks);                 // dq = round(dS) . K
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      bf16* dst = dq + out_b + (size_t)(row0 + g) * out_row + nt * 8 + c2;
      if (real_lo)
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
      if (real_hi)
        *reinterpret_cast<uint32_t*>(dst + (size_t)8 * out_row) =
            pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
    }
  }
  __syncthreads();                     // round(P) and round(dS) complete; K and V are free

  // ---- step 2: dv and dk of the warp's key rows, contracting over queries
  uint32_t xt[KT][4];
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < KT; ++t) tc_at_frag<D, KT>(xt[t], Ps + row0, t);
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  mma_av<D, KT, Tl::kPitch>(acc, xt, Gs);                   // dv = round(P)^T . dout
  tc_store_staged<D, KT>(acc, 1.f, Vs + row0 * Tl::kPitch, dv + out_b, out_row, row0, s);
#pragma unroll
  for (int t = 0; t < KT; ++t) tc_at_frag<D, KT>(xt[t], Ds + row0, t);
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  mma_av<D, KT, Tl::kPitch>(acc, xt, Qs);                   // dk = round(dS)^T . Q
  tc_store_staged<D, KT>(acc, mul, Ks + row0 * Tl::kPitch, dk + out_b, out_row, row0, s);
}

// One block per (image, group of PER heads), as the forward. Two resident
// blocks a SM are declared, which caps the registers at 128 (the CLIP image
// shape's kResident blocks take 108.5 KB of shared memory, two a SM).
template <int D, int PER, int How>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int out_row, int s, int heads, int causal, float scale) {
  extern __shared__ __align__(16) uint32_t smem_f32[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll 1
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's step 2 still reads its tiles
    bwd_head_f32<D, How>(qkv, dout, dq, dk, dv, out_row, smem_f32, b, g * PER + i, s, heads,
                         causal, scale);
  }
}

// The same grids in bf16, for a sequence padded to 16 * KT rows: the block's
// work, and one kernel for each grid.
template <int D, int PER, int KT>
__device__ __forceinline__ void bwd_block_tc(const bf16* __restrict__ qkv,
                                             const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                                             int out_row, int s, int heads, int causal,
                                             float scale) {
  extern __shared__ __align__(16) uint32_t smem_tc[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll 1
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's step 2 still reads its tiles
    bwd_head_tc<D, KT>(qkv, dout, dq, dk, dv, out_row, smem_tc, b, g * PER + i, s, heads,
                       causal, scale);
  }
}

// The monolithic grid declares a minimum of one resident block: without it
// ptxas caps the registers near 80 for an occupancy that shared memory does
// not allow (4 blocks of 55 KB per SM at CLIP's shape) and spills. The group
// grid keeps ptxas's choice, which does not spill there; the minimum would
// cost it registers and occupancy (attention_variants.py).
template <int D, int KT>
__global__ void __launch_bounds__(TcTile<D, KT>::kThreads, 1)
fused_qkv_bwd_kernel_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int out_row, int s, int heads, int causal, float scale) {
  bwd_block_tc<D, 1, KT>(qkv, dout, dq, dk, dv, out_row, s, heads, causal, scale);
}

template <int D, int KT>
__global__ void __launch_bounds__(TcTile<D, KT>::kThreads)
fused_qkv_bwd_group_kernel_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                              bf16* __restrict__ dq, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int out_row, int s, int heads, int causal,
                              float scale) {
  bwd_block_tc<D, kLane / D, KT>(qkv, dout, dq, dk, dv, out_row, s, heads, causal, scale);
}

// ---------------------------------------------------------------- launchers

template <typename T, int D, int PER, int KT>
cudaError_t launch_fwd(const void* qkv, void* out, int n, int s, int heads, int causal,
                       float scale, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  if constexpr (KT == 0) {
    auto kernel = fused_qkv_fwd_kernel<D, PER>;
    const size_t smem = f32_head_smem<D, kThreads>(s);
    cudaError_t err = allow_smem(kernel, smem, f32_head_smem<D, kThreads>(kMaxSeq), raised);
    if (err != cudaSuccess) return err;
    kernel<<<n * (heads / PER), kThreads, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), s, heads, causal, scale);
  } else {
    auto kernel = fused_qkv_fwd_kernel_tc<D, PER, KT>;
    constexpr size_t smem = tc_fwd_smem<D, KT>();
    cudaError_t err = allow_smem(kernel, smem, smem, raised);
    if (err != cudaSuccess) return err;
    kernel<<<n * (heads / PER), TcTile<D, KT>::kThreads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), s, heads, causal, scale);
  }
  return cudaGetLastError();
}

template <int D, int PER, int How>
cudaError_t launch_bwd_f32(const void* qkv, const void* dout, void* dq, void* dk, void* dv,
                           int out_row, int n, int s, int heads, int causal, float scale,
                           cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  auto kernel = fused_qkv_bwd_kernel<D, PER, How>;
  const size_t smem = f32_bwd_floats<D>((s + 31) / 32 * 32, How) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem, kMaxSmem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<n * (heads / PER), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), out_row, s, heads, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int PER, int KT>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dq, void* dk, void* dv,
                       int out_row, int n, int s, int heads, int causal, float scale,
                       cudaStream_t stream, int* design) {
  if constexpr (KT == 0) {
    *design = f32_bwd_design<D>(s);
    if (*design == kResident)
      return launch_bwd_f32<D, PER, kResident>(qkv, dout, dq, dk, dv, out_row, n, s, heads,
                                               causal, scale, stream);
    return launch_bwd_f32<D, PER, kRecompute>(qkv, dout, dq, dk, dv, out_row, n, s, heads,
                                              causal, scale, stream);
  } else {
    *design = kTensorCores;
    static std::atomic<bool> raised[kMaxDevices];
    auto kernel = [] {                 // at d=128 a lane group is one head: the monolithic kernel
      if constexpr (PER == 1) return fused_qkv_bwd_kernel_tc<D, KT>;
      else return fused_qkv_bwd_group_kernel_tc<D, KT>;
    }();
    constexpr size_t smem = tc_bwd_smem<D, KT>();
    cudaError_t err = allow_smem(kernel, smem, smem, raised);
    if (err != cudaSuccess) return err;
    kernel<<<n * (heads / PER), TcTile<D, KT>::kThreads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), out_row, s, heads, causal, scale);
  }
  return cudaGetLastError();
}

// Calls fn(integral_constant<KT>) with the design for element type T and
// sequence length s: KT = 0, the register tiles of the CUDA cores, for fp32;
// for bf16 the tensor-core design with the sequence padded to 16 * KT rows.
template <typename T, typename Fn>
cudaError_t with_tiles(int s, Fn fn) {
  if constexpr (std::is_same_v<T, float>) {
    return fn(std::integral_constant<int, 0>{});
  } else {
    if (s <= 32) return fn(std::integral_constant<int, 2>{});
    if (s <= 64) return fn(std::integral_constant<int, 4>{});
    if (s <= 80) return fn(std::integral_constant<int, 5>{});
    return fn(std::integral_constant<int, 8>{});
  }
}

// Every design copies 16 bytes at a time.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Calls fn(T*, integral_constant<D>) for the element type and head dim the
// kernels are built for; anything else is an invalid value.
template <typename Fn>
cudaError_t dispatch(int dtype, int d, Fn fn) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == 0 && d == 64) return fn(static_cast<float*>(nullptr), D64{});
  if (dtype == 0 && d == 128) return fn(static_cast<float*>(nullptr), D128{});
  if (dtype == 1 && d == 64) return fn(static_cast<__nv_bfloat16*>(nullptr), D64{});
  if (dtype == 1 && d == 128) return fn(static_cast<__nv_bfloat16*>(nullptr), D128{});
  return cudaErrorInvalidValue;
}

// PER = heads per block: 1 on the monolithic grid, the heads of a 128-lane
// group (128 / d) on the group grid.
cudaError_t fwd(const void* qkv, void* out, int n, int s, int heads, int d, int dtype, int causal,
                float scale, void* stream, bool group) {
  if (n < 1 || s < 1 || s > kMaxSeq || heads < 1) return cudaErrorInvalidValue;
  if (group && (d <= 0 || (heads * d) % kLane != 0)) return cudaErrorInvalidValue;
  if (!aligned16({qkv, out})) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, [&](auto* tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    return with_tiles<T>(s, [&](auto tiles) {
      constexpr int KT = decltype(tiles)::value;
      return group ? launch_fwd<T, D, kLane / D, KT>(qkv, out, n, s, heads, causal, scale, st)
                   : launch_fwd<T, D, 1, KT>(qkv, out, n, s, heads, causal, scale, st);
    });
  });
}

// Both grids write the packed d(qkv): dq, dk and dv are its three column
// blocks, rows 3*H*d elements apart. *design gets the design launched.
cudaError_t bwd(const void* qkv, const void* dout, void* dqkv, int n, int s, int heads, int d,
                int dtype, int causal, float scale, void* stream, bool group, int* design) {
  if (n < 1 || s < 1 || s > kMaxSeq || heads < 1) return cudaErrorInvalidValue;
  if (group && (d <= 0 || (heads * d) % kLane != 0)) return cudaErrorInvalidValue;
  if (!aligned16({qkv, dout, dqkv})) return cudaErrorMisalignedAddress;
  const int out_row = 3 * heads * d;
  char* dq = static_cast<char*>(dqkv);
  char* dk = dq + (size_t)heads * d * (dtype == 0 ? 4 : 2);   // one column block on
  char* dv = dk + (dk - dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, [&](auto* tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    return with_tiles<T>(s, [&](auto tiles) {
      constexpr int KT = decltype(tiles)::value;
      return group ? launch_bwd<T, D, kLane / D, KT>(qkv, dout, dq, dk, dv, out_row, n, s,
                                                     heads, causal, scale, st, design)
                   : launch_bwd<T, D, 1, KT>(qkv, dout, dq, dk, dv, out_row, n, s, heads,
                                             causal, scale, st, design);
    });
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 on
// success), launches on `stream`, which must belong to the current device (the
// caller sets it), and does not synchronise.

// _fwd_compute: qkv (n, s, 3*H*d) -> out (n, s, H*d), one block per (image, head).
extern "C" int eoe_fused_qkv_attention_fwd(const void* qkv, void* out, int n, int s, int heads,
                                           int d, int dtype, int causal, float scale,
                                           void* stream) {
  return (int)fwd(qkv, out, n, s, heads, d, dtype, causal, scale, stream, false);
}

// _bwd_compute: qkv, dout (n, s, H*d) -> dqkv (n, s, 3*H*d) packed [dq | dk | dv].
// Writes the design it launched to *design (0: bf16 tensor cores, 1: fp32
// resident, 2: fp32 recompute).
extern "C" int eoe_fused_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv, int n,
                                           int s, int heads, int d, int dtype, int causal,
                                           float scale, void* stream, int* design) {
  return (int)bwd(qkv, dout, dqkv, n, s, heads, d, dtype, causal, scale, stream, false, design);
}

// _fwd_group_compute: as eoe_fused_qkv_attention_fwd, one block per (image,
// 128-lane group of heads).
extern "C" int eoe_fused_qkv_attention_group_fwd(const void* qkv, void* out, int n, int s,
                                                 int heads, int d, int dtype, int causal,
                                                 float scale, void* stream) {
  return (int)fwd(qkv, out, n, s, heads, d, dtype, causal, scale, stream, true);
}

// _bwd_group_compute with _group_grid_call's concatenation: as
// eoe_fused_qkv_attention_bwd, one block per (image, 128-lane group of heads).
extern "C" int eoe_fused_qkv_attention_group_bwd(const void* qkv, const void* dout, void* dqkv,
                                                 int n, int s, int heads, int d, int dtype,
                                                 int causal, float scale, void* stream,
                                                 int* design) {
  return (int)bwd(qkv, dout, dqkv, n, s, heads, d, dtype, causal, scale, stream, true, design);
}
