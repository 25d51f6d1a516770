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
// once, then + mask; an fp32 softmax with the row max subtracted; P = p / sum
// normalised BEFORE it is rounded to v's dtype; P.V accumulated in fp32 and
// cast to the output dtype. A row whose logits are all -inf gives NaN, as
// the JAX kernel does; a row with one finite logit is finite.
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
// it is bound by bytes. This first version is the simple correct design:
//   - one block per (n*h, tile of 32 query rows); 8 warps, each owning 4 rows;
//   - q rows in fp32 in shared memory (zero-padded to a multiple of 32);
//   - K, then V, staged through shared memory 32 keys at a time (S=1024 at
//     d=256 does not fit whole: 1 MB per tensor in fp32);
//   - pass 1 over the key tiles: each lane one key, the logits of the warp's
//     4 rows into a row of shared memory (S floats a row, 128 KB for the 32
//     rows at S=1024); then max, sum and the rounded P from that row, as
//     _kernel does, with no rescaling of partial sums;
//   - pass 2 over the value tiles: each lane owns output columns lane,
//     lane+32, ...; P.V accumulated in fp32 registers.
// A head dim above 256 is walked in chunks of 256 columns: pass 1 runs once
// per chunk and sums the chunks' partial q.k in fp32 in the logit rows, which
// are scaled and masked after the last chunk; pass 2 runs once per chunk and
// writes that chunk's output columns. With one chunk (d <= 256) the
// arithmetic is the single-pass one.
// Products are fp32 FMAs on CUDA cores from shared memory (float4 reads of K,
// rows padded by 4 words so a quarter-warp's reads hit distinct banks). What
// it does not yet do is use the tensor cores or overlap loads with compute.

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

using namespace eoe;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile: one per lane
constexpr int kMaxSeq = 1024;                 // MAX_SINGLE_BLOCK

// Element strides of one tensor's n, h and s axes; d is contiguous.
struct Strides {
  long long n, h, s;
};

struct Layout {
  Strides q, k, v, out;
};

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

}  // namespace

// q, k, v, out: (n, heads, s, d) with element strides strides[0..2] (q),
// [3..5] (k), [6..8] (v), [9..11] (out) for the n, h and s axes and d
// contiguous; mask: a contiguous fp32 (s, s) array or null. dtype: 0 =
// float32, 1 = bfloat16, the same for q, k, v and out. Returns a cudaError_t
// (0 on success), launches on `stream`, which must belong to the current
// device (the caller sets it), and does not synchronise.
extern "C" int eoe_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const float* mask, void* out, int n, int heads, int s,
                                       int d, int dtype, const long long* strides, float scale,
                                       void* stream) {
  if (n < 1 || heads < 1 || s < 1 || s > kMaxSeq || d < 1) return (int)cudaErrorInvalidValue;
  const Layout lay{{strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                   {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_for_dim<float>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  if (dtype == 1)
    return (int)launch_for_dim<__nv_bfloat16>(q, k, v, mask, out, lay, n, heads, s, d, scale, st);
  return (int)cudaErrorInvalidValue;
}
