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
// group's q, k, v (and dout) columns; the backward then writes dq, dk and dv
// as three (n, s, H*d) tensors, which the caller concatenates. The per-head
// code is the same on both grids (fwd_head, bwd_head), so the two grids give
// the same bits; a group's heads run one after the other in its block. Both CLIP
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
// the limit: they are bound by bytes. This first version of each is the simple
// correct design: one block per (image, head), s x D tiles in shared memory
// (one padding word per row, so a warp reading one column across 32 rows hits
// 32 banks), one warp per row, CUDA-core fp32 FMAs for every product. What
// they do not yet do is keep enough bytes in flight (no cp.async/TMA pipeline)
// or use the tensor cores.
//
// The backward in two phases inside one block, so that no float atomics sum
// dk and dv across blocks and the result does not depend on block order:
//   1. K and V in shared memory, one warp per query row r: P_r, dp_r and
//      dS_r, the row's statistics (max, sum, rowsum(dp*P)) kept in shared
//      memory, and dq_r written out;
//   2. Q and dout in the same shared memory, one warp per key row j: P and dS
//      of column j recomputed from the row statistics with the same
//      operations (so bit for bit the same values), then dk_j = sum_r dS_rj q_r
//      and dv_j = sum_r round(P_rj) dout_r written out.
// Only two tiles are resident at a time, so fp32 at d=128, s=128 needs
// 150 KB of shared memory, not the 264 KB of four tiles. q, k, v and dout are
// each read twice; the second read is of rows the block has just read, and
// mostly hits L2.

#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace eoe;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;                 // one tile covers the sequence
constexpr int kLane = 128;                   // the TPU kernel's lane group
constexpr int kKeysPerLane = kMaxSeq / 32;
constexpr float kMasked = -1e30f;            // the TPU kernel's additive bias

// One head's s x D tile in shared memory, rows padded by one 32-bit word.
template <typename T, int D>
struct Tile {
  static constexpr int kWords = D * (int)sizeof(T) / 4;     // words of one row
  static constexpr int kPitchWords = kWords + 1;
  static constexpr int kPitch = kPitchWords * 4 / (int)sizeof(T);  // in elements
};

template <typename T, int D>
size_t smem_bytes(int s) {
  return (size_t)3 * s * Tile<T, D>::kPitchWords * 4 + (size_t)kWarps * kMaxSeq * sizeof(float);
}

// The forward of one (image b, head h), by the whole block.
template <typename T, int D>
__device__ __forceinline__ void fwd_head(const T* __restrict__ qkv, T* __restrict__ out,
                                         uint32_t* smem, int b, int h, int s, int heads,
                                         int causal, float scale) {
  using Tl = Tile<T, D>;
  const int width = heads * D;                       // model width, elements
  const int width_words = width * (int)sizeof(T) / 4;
  const int row_words = 3 * width_words;             // one qkv row

  // 1. q, k, v of head h, strided from the joint projection into shared memory.
  //    Consecutive threads read consecutive words of a row.
  uint32_t* tiles = smem;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * s * row_words;
  const int head_word = h * Tl::kWords;
  for (int i = threadIdx.x; i < 3 * s * Tl::kWords; i += kThreads) {
    const int w = i % Tl::kWords;
    const int j = (i / Tl::kWords) % s;
    const int t = i / (Tl::kWords * s);
    tiles[(t * s + j) * Tl::kPitchWords + w] =
        src[(size_t)j * row_words + t * width_words + head_word + w];
  }
  __syncthreads();

  const T* Qs = reinterpret_cast<const T*>(tiles);
  const T* Ks = Qs + s * Tl::kPitch;
  const T* Vs = Ks + s * Tl::kPitch;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_row = reinterpret_cast<float*>(smem + 3 * s * Tl::kPitchWords) + warp * kMaxSeq;
  T* dst = out + (size_t)b * s * width + h * D;

  // 2. One warp per query row.
  for (int r = warp; r < s; r += kWarps) {
    const int n_keys = causal ? r + 1 : s;           // keys row r may attend to
    const int n_chunks = (n_keys + 31) / 32;         // uniform across the warp

    // logits: lane owns keys lane, lane+32, lane+64, lane+96
    float logit[kKeysPerLane];
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) logit[c] = 0.f;
    const T* q = Qs + r * Tl::kPitch;
    for (int k = 0; k < D; ++k) {
      const float qk = to_f32(q[k]);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        if (c < n_chunks) {
          const int j = min(lane + 32 * c, s - 1);
          logit[c] = fmaf(qk, to_f32(Ks[j * Tl::kPitch + k]), logit[c]);
        }
      }
    }

    // fp32 softmax over the allowed keys; masked keys contribute exp(-1e30-m)=0
    float m = kMasked;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      logit[c] = j < n_keys ? logit[c] * scale : kMasked;
      m = fmaxf(m, logit[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      logit[c] = j < n_keys ? expf(logit[c] - m) : 0.f;
      sum += logit[c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int j = lane + 32 * c;
      if (j < n_keys) p_row[j] = to_f32(from_f32<T>(logit[c] / sum));  // P in input dtype
    }
    __syncwarp();

    // P.V in fp32: lane owns output columns lane, lane+32, ...
    float acc[D / 32];
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_keys; ++j) {
      const float p = p_row[j];
      const T* v = Vs + j * Tl::kPitch;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(p, to_f32(v[lane + 32 * i]), acc[i]);
    }
    T* o = dst + (size_t)r * width;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) o[lane + 32 * i] = from_f32<T>(acc[i]);
    __syncwarp();  // p_row is rewritten by this warp's next row
  }
}

// One block per (image, group of PER heads), the heads of a group one after
// the other. PER=1 is the monolithic grid of _fwd_compute; PER=128/D is the
// lane-group grid of _fwd_group_compute (two heads at d=64, one at d=128).
template <typename T, int D, int PER>
__global__ void __launch_bounds__(kThreads)
fused_qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int s, int heads,
                     int causal, float scale) {
  extern __shared__ uint32_t smem[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's tiles are still being read
    fwd_head<T, D>(qkv, out, smem, b, g * PER + i, s, heads, causal, scale);
  }
}

// ---------------------------------------------------------------- backward

// dS of one (row, key) pair from the fp32 P, before its rounding. The
// explicit-rounding intrinsics keep nvcc from contracting these into FMAs, so
// both phases compute the same bits.
template <int D>
__device__ __forceinline__ float grad_logit(float dp, float rowsum, float p, float scale) {
  const float ds = __fmul_rn(__fsub_rn(dp, rowsum), p);
  return D == 128 ? __fmul_rn(ds, scale) : ds;   // d=64 scales dq and dk instead
}

// The softmax probability of a logit from its row's max and sum.
__device__ __forceinline__ float prob(float logit, float scale, float m, float sum) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(logit, scale), m)), sum);
}

// Copy rows [0, s) of one head's D columns, starting at word `col_word` of
// rows `row_words` words apart, into a padded shared-memory tile.
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint32_t* dst, const uint32_t* src, int s,
                                          int row_words, int col_word) {
  using Tl = Tile<T, D>;
  for (int i = threadIdx.x; i < s * Tl::kWords; i += kThreads) {
    const int w = i % Tl::kWords;
    const int j = i / Tl::kWords;
    dst[j * Tl::kPitchWords + w] = src[(size_t)j * row_words + col_word + w];
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_row(float* dst, const T* src) {
  for (int c = threadIdx.x % 32; c < D; c += 32) dst[c] = to_f32(src[c]);
}

template <int D>
__host__ __device__ constexpr int warp_floats() { return 2 * D + 2 * kMaxSeq; }  // two D rows, two s rows

template <typename T, int D>
size_t bwd_smem_bytes(int s) {
  return (size_t)2 * s * Tile<T, D>::kPitchWords * 4 +
         ((size_t)kWarps * warp_floats<D>() + 3 * kMaxSeq) * sizeof(float);
}

// The backward of one (image b, head h), by the whole block. Row j of image
// b, head h, of dq starts at dq + (b * s + j) * out_row + h * D, and so for dk
// and dv: the monolithic kernel writes the packed d(qkv) (three column blocks
// of rows 3*H*D long), the lane-group kernel three (n, s, H*D) tensors, as
// _bwd_group_compute's three outputs. The three never overlap, and they are
// __restrict__ so that the global reads of q, k, v and dout may take the
// read-only path.
template <typename T, int D>
__device__ __forceinline__ void bwd_head(const T* __restrict__ qkv, const T* __restrict__ dout,
                                         T* __restrict__ dq, T* __restrict__ dk,
                                         T* __restrict__ dv, int out_row, uint32_t* smem, int b,
                                         int h, int s, int heads, int causal, float scale) {
  using Tl = Tile<T, D>;
  const int width = heads * D;
  const int width_words = width * (int)sizeof(T) / 4;
  const int qkv_row_words = 3 * width_words;
  const int head_word = h * Tl::kWords;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  uint32_t* tiles = smem;
  float* scratch = reinterpret_cast<float*>(smem + 2 * s * Tl::kPitchWords);
  float* row_a = scratch + warp * warp_floats<D>();   // D floats
  float* row_b = row_a + D;                            // D floats
  float* col_a = row_b + D;                            // kMaxSeq floats
  float* col_b = col_a + kMaxSeq;                      // kMaxSeq floats
  float* stat_m = scratch + kWarps * warp_floats<D>(); // per query row: max,
  float* stat_l = stat_m + kMaxSeq;                    // sum of exp,
  float* stat_d = stat_l + kMaxSeq;                    // rowsum(dp * P)

  const uint32_t* qkv_w = reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * s * qkv_row_words;
  const uint32_t* dout_w = reinterpret_cast<const uint32_t*>(dout) + (size_t)b * s * width_words;
  const T* qkv_b = qkv + (size_t)b * s * 3 * width + h * D;   // q of row 0, head h
  const T* dout_b = dout + (size_t)b * s * width + h * D;
  const size_t out_b = (size_t)b * s * out_row + h * D;   // row 0 of image b, head h
  const int n_chunks = (s + 31) / 32;

  // ---- phase 1: K, V resident; one warp per query row
  load_tile<T, D>(tiles, qkv_w, s, qkv_row_words, width_words + head_word);
  load_tile<T, D>(tiles + s * Tl::kPitchWords, qkv_w, s, qkv_row_words,
                  2 * width_words + head_word);
  __syncthreads();
  {
    const T* Ks = reinterpret_cast<const T*>(tiles);
    const T* Vs = Ks + s * Tl::kPitch;
    for (int r = warp; r < s; r += kWarps) {
      const int n_keys = causal ? r + 1 : s;
      const int chunks = (n_keys + 31) / 32;
      load_row<T, D>(row_a, qkv_b + (size_t)r * 3 * width);   // q_r
      load_row<T, D>(row_b, dout_b + (size_t)r * width);      // dout_r
      __syncwarp();
      // lane owns keys lane, lane+32, ...: logits q_r.k_j and dp = dout_r.v_j
      float logit[kKeysPerLane], dp[kKeysPerLane];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) logit[c] = dp[c] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float qk = row_a[k], gk = row_b[k];
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          if (c < chunks) {
            const int j = min(lane + 32 * c, s - 1);
            logit[c] = fmaf(qk, to_f32(Ks[j * Tl::kPitch + k]), logit[c]);
            dp[c] = fmaf(gk, to_f32(Vs[j * Tl::kPitch + k]), dp[c]);
          }
        }
      }
      float m = kMasked;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        if (lane + 32 * c < n_keys) m = fmaxf(m, __fmul_rn(logit[c], scale));
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        if (lane + 32 * c < n_keys) sum += expf(__fsub_rn(__fmul_rn(logit[c], scale), m));
      }
      sum = warp_sum(sum);
      float p[kKeysPerLane];
      float rowsum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        p[c] = lane + 32 * c < n_keys ? prob(logit[c], scale, m, sum) : 0.f;
        rowsum = fmaf(dp[c], p[c], rowsum);
      }
      rowsum = warp_sum(rowsum);
      if (lane == 0) {
        stat_m[r] = m;
        stat_l[r] = sum;
        stat_d[r] = rowsum;
      }
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < n_keys) col_a[j] = round_to<T>(grad_logit<D>(dp[c], rowsum, p[c], scale));
      }
      __syncwarp();
      // dq_r = sum_j dS_rj k_j: lane owns columns lane, lane+32, ...
      float acc[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
      for (int j = 0; j < n_keys; ++j) {
        const float w = col_a[j];
        const T* kr = Ks + j * Tl::kPitch;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) acc[i] = fmaf(w, to_f32(kr[lane + 32 * i]), acc[i]);
      }
      T* dq_r = dq + out_b + (size_t)r * out_row;
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        dq_r[lane + 32 * i] = from_f32<T>(D == 64 ? acc[i] * scale : acc[i]);
      __syncwarp();  // row_a, row_b and col_a are rewritten by this warp's next row
    }
  }
  __syncthreads();  // row statistics complete; K and V no longer needed

  // ---- phase 2: Q, dout resident; one warp per key row
  load_tile<T, D>(tiles, qkv_w, s, qkv_row_words, head_word);
  load_tile<T, D>(tiles + s * Tl::kPitchWords, dout_w, s, width_words, head_word);
  __syncthreads();
  const T* Qs = reinterpret_cast<const T*>(tiles);
  const T* Gs = Qs + s * Tl::kPitch;
  for (int j = warp; j < s; j += kWarps) {
    const int r0 = causal ? j : 0;                    // first query row that sees key j
    load_row<T, D>(row_a, qkv_b + (size_t)j * 3 * width + width);      // k_j
    load_row<T, D>(row_b, qkv_b + (size_t)j * 3 * width + 2 * width);  // v_j
    __syncwarp();
    // lane owns query rows lane, lane+32, ...; the same products as phase 1
    float logit[kKeysPerLane], dp[kKeysPerLane];
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) logit[c] = dp[c] = 0.f;
    for (int k = 0; k < D; ++k) {
      const float kk = row_a[k], vk = row_b[k];
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        if (c < n_chunks) {
          const int r = min(lane + 32 * c, s - 1);
          logit[c] = fmaf(to_f32(Qs[r * Tl::kPitch + k]), kk, logit[c]);
          dp[c] = fmaf(to_f32(Gs[r * Tl::kPitch + k]), vk, dp[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kKeysPerLane; ++c) {
      const int r = lane + 32 * c;
      if (r >= r0 && r < s) {
        const float p = prob(logit[c], scale, stat_m[r], stat_l[r]);
        col_a[r] = round_to<T>(p);
        col_b[r] = round_to<T>(grad_logit<D>(dp[c], stat_d[r], p, scale));
      }
    }
    __syncwarp();
    // dv_j = sum_r round(P_rj) dout_r, dk_j = sum_r dS_rj q_r
    float acc_k[D / 32], acc_v[D / 32];
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc_k[i] = acc_v[i] = 0.f;
    for (int r = r0; r < s; ++r) {
      const float pc = col_a[r], ds = col_b[r];
      const T* qr = Qs + r * Tl::kPitch;
      const T* gr = Gs + r * Tl::kPitch;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        acc_v[i] = fmaf(pc, to_f32(gr[lane + 32 * i]), acc_v[i]);
        acc_k[i] = fmaf(ds, to_f32(qr[lane + 32 * i]), acc_k[i]);
      }
    }
    T* dk_j = dk + out_b + (size_t)j * out_row;
    T* dv_j = dv + out_b + (size_t)j * out_row;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      dk_j[lane + 32 * i] = from_f32<T>(D == 64 ? acc_k[i] * scale : acc_k[i]);
      dv_j[lane + 32 * i] = from_f32<T>(acc_v[i]);
    }
    __syncwarp();
  }
}

// One block per (image, group of PER heads), as the forward.
template <typename T, int D, int PER>
__global__ void __launch_bounds__(kThreads)
fused_qkv_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int out_row, int s, int heads,
                     int causal, float scale) {
  extern __shared__ uint32_t smem[];
  const int groups = heads / PER;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i > 0) __syncthreads();  // the previous head's phase 2 still reads its tiles
    bwd_head<T, D>(qkv, dout, dq, dk, dv, out_row, smem, b, g * PER + i, s, heads, causal,
                   scale);
  }
}

// ---------------------------------------------------------------- launchers

template <typename T, int D, int PER>
cudaError_t launch_fwd(const void* qkv, void* out, int n, int s, int heads, int causal,
                       float scale, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  auto kernel = fused_qkv_fwd_kernel<T, D, PER>;
  const size_t smem = smem_bytes<T, D>(s);
  cudaError_t err = allow_smem(kernel, smem, smem_bytes<T, D>(kMaxSeq), raised);
  if (err != cudaSuccess) return err;
  kernel<<<n * (heads / PER), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), s, heads, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int PER>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dq, void* dk, void* dv,
                       int out_row, int n, int s, int heads, int causal, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  auto kernel = fused_qkv_bwd_kernel<T, D, PER>;
  const size_t smem = bwd_smem_bytes<T, D>(s);
  cudaError_t err = allow_smem(kernel, smem, bwd_smem_bytes<T, D>(kMaxSeq), raised);
  if (err != cudaSuccess) return err;
  kernel<<<n * (heads / PER), kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), out_row, s, heads, causal, scale);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, [&](auto* tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    return group ? launch_fwd<T, D, kLane / D>(qkv, out, n, s, heads, causal, scale, st)
                 : launch_fwd<T, D, 1>(qkv, out, n, s, heads, causal, scale, st);
  });
}

cudaError_t bwd(const void* qkv, const void* dout, void* dq, void* dk, void* dv, int out_row,
                int n, int s, int heads, int d, int dtype, int causal, float scale, void* stream,
                bool group) {
  if (n < 1 || s < 1 || s > kMaxSeq || heads < 1) return cudaErrorInvalidValue;
  if (group && (d <= 0 || (heads * d) % kLane != 0)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, [&](auto* tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    return group ? launch_bwd<T, D, kLane / D>(qkv, dout, dq, dk, dv, out_row, n, s, heads,
                                               causal, scale, st)
                 : launch_bwd<T, D, 1>(qkv, dout, dq, dk, dv, out_row, n, s, heads, causal,
                                       scale, st);
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
extern "C" int eoe_fused_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv, int n,
                                           int s, int heads, int d, int dtype, int causal,
                                           float scale, void* stream) {
  const size_t width = (size_t)heads * d * (dtype == 0 ? 4 : 2);   // bytes of one column block
  char* base = static_cast<char*>(dqkv);
  return (int)bwd(qkv, dout, base, base + width, base + 2 * width, 3 * heads * d, n, s, heads, d,
                  dtype, causal, scale, stream, false);
}

// _fwd_group_compute: as eoe_fused_qkv_attention_fwd, one block per (image,
// 128-lane group of heads).
extern "C" int eoe_fused_qkv_attention_group_fwd(const void* qkv, void* out, int n, int s,
                                                 int heads, int d, int dtype, int causal,
                                                 float scale, void* stream) {
  return (int)fwd(qkv, out, n, s, heads, d, dtype, causal, scale, stream, true);
}

// _bwd_group_compute: dq, dk and dv into three (n, s, H*d) tensors, one block
// per (image, 128-lane group of heads).
extern "C" int eoe_fused_qkv_attention_group_bwd(const void* qkv, const void* dout, void* dq,
                                                 void* dk, void* dv, int n, int s, int heads,
                                                 int d, int dtype, int causal, float scale,
                                                 void* stream) {
  return (int)bwd(qkv, dout, dq, dk, dv, heads * d, n, s, heads, d, dtype, causal, scale, stream,
                  true);
}
