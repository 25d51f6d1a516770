// CBAM's channel and spatial gates with a BasicBlock's residual add and ReLU,
// forward and backward, on channels-last (NHWC) activations: the kernels of
// eoe_tpu_torch/ops/cbam.py, which documents the chain and its plain
// versions (``*_ref``).
//
// It replaces no TPU kernel: in the JAX package XLA fuses the chain's
// elementwise work into the surrounding ops. Run as ATen ops, the chain
// passes over each block's activation about 50 times (broadcast multiplies
// on ATen's strided path, the amax masks, three full-size gradients summed
// into o and into x1). Bytes bound every kernel here, so each passes over
// the activation once: the gated tensor x1 = o * cg is formed in registers
// wherever it is needed and never stored, and the small maps (cg (n, c),
// the spatial gate's (n, h, w)) are read through the cache.
//
// A pixel's c channels are contiguous; every kernel reads and writes them
// in 16-byte pieces (4 fp32 or 8 bf16 values) and computes in fp32.
//  - Row kernels (K2 spatial_pool, K3 gate, B1 gate_bwd, B3 input_bwd):
//    `lanes` threads of a warp (a power of two up to 32) share a pixel, each
//    taking every lanes-th piece; blocks stride over the pixels. A pixel's
//    reductions over its channels are shuffles within its lanes.
//  - Pool kernels (K1 channel_pool, B2 channel_bwd): reductions over the
//    pixels of each (image, channel). A block takes one image's band of
//    pixels, `lanes` threads across a pixel's pieces (one each) and `rows`
//    pixels at a time; it merges its rows through shared memory in a fixed
//    order and writes a partial per band; a second small kernel merges the
//    bands in order. No float atomics: two runs give the same bits.
// x1 is formed with __fmul_rn everywhere, so the backward's equality masks
// [x1 = max_c x1] find exactly the maxima the forward found. The max over a
// set is carried with its tie count and merged as (m, k) pairs; a tie
// splits the gradient evenly, as torch.amax's backward does.

#include "common.cuh"

namespace {

using eoe::bf16;
using eoe::from_f32;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The values of one 16-byte piece of T.
template <typename T> struct Piece;
template <> struct Piece<float> { static constexpr int kN = 4; };
template <> struct Piece<bf16> { static constexpr int kN = 8; };

template <typename T>
__device__ __forceinline__ void load(const T* p, float (&v)[Piece<T>::kN]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (Piece<T>::kN == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower half holds the first value
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[Piece<T>::kN]) {
  uint32_t w[4];
  if constexpr (Piece<T>::kN == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// N consecutive fp32 values (N a multiple of 4, p 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

// (m, k) <- the max of two sets with its tie count.
__device__ __forceinline__ void merge_max(float& m, float& k, float m2, float k2) {
  if (m2 > m) {
    m = m2;
    k = k2;
  } else if (m2 == m) {
    k += k2;
  }
}

// The pixels a row kernel's thread group visits: `base` is uniform over the
// warp, so every lane runs the same iterations and the shuffles see all 32.
struct Rows {
  long long first, stride;
  int group, sub, lanes;
  __device__ Rows(int lanes_) : lanes(lanes_) {
    const int lane = threadIdx.x & 31, per_warp = 32 / lanes;
    group = lane / lanes;
    sub = lane % lanes;
    first = ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * per_warp;
    stride = (long long)gridDim.x * (blockDim.x >> 5) * per_warp;
  }
};

__device__ __forceinline__ float lanes_sum(float s, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// K2: per pixel, [max_c x1, mean_c x1] into compress (n, 2, hw) in T, and
// the max (fp32) with its tie count into cmax and ties (n, hw).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_spatial_pool_kernel(const T* __restrict__ o, const float* __restrict__ cg,
                             T* __restrict__ compress, float* __restrict__ cmax,
                             float* __restrict__ ties, int n, int hw, int c, int lanes) {
  constexpr int K = Piece<T>::kN;
  const int pieces = c / K;
  const long long pixels = (long long)n * hw;
  const Rows rows(lanes);
  for (long long base = rows.first; base < pixels; base += rows.stride) {
    const long long p = base + rows.group;
    float m = -INFINITY, k = 0.f, s = 0.f;
    if (p < pixels) {
      const T* row = o + p * c;
      const float* g = cg + (p / hw) * c;
      for (int j = rows.sub; j < pieces; j += lanes) {
        float v[K], gv[K];
        load(row + j * K, v);
        load_f32<K>(g + j * K, gv);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          const float x = __fmul_rn(v[e], gv[e]);
          s += x;
          merge_max(m, k, x, 1.f);
        }
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m, off), k2 = __shfl_xor_sync(kFull, k, off);
      s += __shfl_xor_sync(kFull, s, off);
      merge_max(m, k, m2, k2);
    }
    if (p < pixels && rows.sub == 0) {
      const long long img = p / hw, q = p % hw;
      compress[img * 2 * hw + q] = from_f32<T>(m);
      compress[(img * 2 + 1) * hw + q] = from_f32<T>(s / (float)c);
      cmax[p] = m;
      ties[p] = k;
    }
  }
}

// K3: y = relu(o * cg * sg + r), sg (n, hw).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_gate_kernel(const T* __restrict__ o, const float* __restrict__ cg,
                     const float* __restrict__ sg, const T* __restrict__ r, T* __restrict__ y,
                     int n, int hw, int c, int lanes) {
  constexpr int K = Piece<T>::kN;
  const int pieces = c / K;
  const long long pixels = (long long)n * hw;
  const Rows rows(lanes);
  for (long long p = rows.first + rows.group; p < pixels; p += rows.stride) {
    const float s = __ldg(sg + p);
    const float* g = cg + (p / hw) * c;
    for (int j = rows.sub; j < pieces; j += lanes) {
      float v[K], rv[K], gv[K];
      load(o + p * c + j * K, v);
      load(r + p * c + j * K, rv);
      load_f32<K>(g + j * K, gv);
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const float z = __fadd_rn(__fmul_rn(__fmul_rn(v[e], gv[e]), s), rv[e]);
        v[e] = z <= 0.f ? 0.f : z;  // relu, NaN kept
      }
      store(y + p * c + j * K, v);
    }
  }
}

// B1: g' = gy [y > 0] into dr, g' sg into gx1 (x1's gradient through the
// tail), sum_c g' x1 into dsg (n, hw).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_gate_bwd_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                         const T* __restrict__ o, const float* __restrict__ cg,
                         const float* __restrict__ sg, T* __restrict__ dr, T* __restrict__ gx1,
                         float* __restrict__ dsg, int n, int hw, int c, int lanes) {
  constexpr int K = Piece<T>::kN;
  const int pieces = c / K;
  const long long pixels = (long long)n * hw;
  const Rows rows(lanes);
  for (long long base = rows.first; base < pixels; base += rows.stride) {
    const long long p = base + rows.group;
    float acc = 0.f;
    if (p < pixels) {
      const float s = __ldg(sg + p);
      const float* g = cg + (p / hw) * c;
      for (int j = rows.sub; j < pieces; j += lanes) {
        const long long at = p * c + j * K;
        float gv[K], yv[K], ov[K], cv[K], tail[K];
        load(gy + at, gv);
        load(y + at, yv);
        load(o + at, ov);
        load_f32<K>(g + j * K, cv);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          gv[e] = yv[e] <= 0.f ? 0.f : gv[e];  // torch's threshold_backward
          tail[e] = gv[e] * s;
          acc += gv[e] * __fmul_rn(ov[e], cv[e]);
        }
        store(dr + at, gv);
        store(gx1 + at, tail);
      }
    }
    acc = lanes_sum(acc, lanes);
    if (p < pixels && rows.sub == 0) dsg[p] = acc;
  }
}

// x1's whole gradient at one value: the tail's, the channel max's (a per
// tie at the max) and the channel mean's (b).
__device__ __forceinline__ float grad_x1(float tail, float x1, float cm, float a, float b) {
  return tail + (x1 == cm ? a : 0.f) + b;
}

// B3: go = gx1 cg + gmx [o = mx] / mx_ties + gavg / hw; gc (n, 2, hw) is the
// spatial gate input's gradient in T, cmax and ties K2's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_input_bwd_kernel(const T* __restrict__ gx1, const T* __restrict__ o,
                          const float* __restrict__ cg, const T* __restrict__ gc,
                          const float* __restrict__ cmax, const float* __restrict__ ties,
                          const T* __restrict__ mx, const float* __restrict__ mx_ties,
                          const float* __restrict__ gmx, const float* __restrict__ gavg,
                          T* __restrict__ go, int n, int hw, int c, int lanes) {
  constexpr int K = Piece<T>::kN;
  const int pieces = c / K;
  const long long pixels = (long long)n * hw;
  const float inv_hw = 1.f / (float)hw;
  const Rows rows(lanes);
  for (long long p = rows.first + rows.group; p < pixels; p += rows.stride) {
    const long long img = p / hw, q = p % hw;
    const float a = eoe::to_f32(gc[img * 2 * hw + q]) / __ldg(ties + p);
    const float b = eoe::to_f32(gc[(img * 2 + 1) * hw + q]) / (float)c;
    const float cm = __ldg(cmax + p);
    const long long col = img * c;
    for (int j = rows.sub; j < pieces; j += lanes) {
      const long long at = p * c + j * K;
      float tv[K], ov[K], cv[K], mv[K], kv[K], gm[K], ga[K];
      load(gx1 + at, tv);
      load(o + at, ov);
      load_f32<K>(cg + col + j * K, cv);
      load(mx + col + j * K, mv);
      load_f32<K>(mx_ties + col + j * K, kv);
      load_f32<K>(gmx + col + j * K, gm);
      load_f32<K>(gavg + col + j * K, ga);
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const float g = grad_x1(tv[e], __fmul_rn(ov[e], cv[e]), cm, a, b);
        tv[e] = g * cv[e] + (ov[e] == mv[e] ? gm[e] / kv[e] : 0.f) + ga[e] * inv_hw;
      }
      store(go + at, tv);
    }
  }
}

// The pool kernels' thread: `x` its piece of the pixel (x < lanes), `y`
// its row (y < rows); threads past lanes * rows only join the barriers.
struct Pool {
  int x, y, rows;
  bool active;
  __device__ Pool(int lanes, int rows_) : rows(rows_) {
    x = threadIdx.x % lanes;
    y = threadIdx.x / lanes;
    active = y < rows;
  }
};

// K1, first stage: per (image, band), the sum, the max and its tie count of
// each channel over the band's pixels, into partial (n, splits, 3, c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_channel_pool_kernel(const T* __restrict__ o, float* __restrict__ partial, int hw,
                             int c, int lanes, int rows, int band) {
  constexpr int K = Piece<T>::kN;
  __shared__ float red[3][kThreads * K];
  const Pool t(lanes, rows);
  const int img = blockIdx.y, split = blockIdx.x;
  const int q0 = split * band, q1 = min(hw, q0 + band);
  float s[K], m[K], k[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    s[e] = 0.f;
    m[e] = -INFINITY;
    k[e] = 0.f;
  }
  if (t.active) {
    for (int q = q0 + t.y; q < q1; q += rows) {
      float v[K];
      load(o + ((long long)img * hw + q) * c + t.x * K, v);
#pragma unroll
      for (int e = 0; e < K; ++e) {
        s[e] += v[e];
        merge_max(m[e], k[e], v[e], 1.f);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < K; ++e) {
    red[0][threadIdx.x * K + e] = s[e];
    red[1][threadIdx.x * K + e] = m[e];
    red[2][threadIdx.x * K + e] = k[e];
  }
  __syncthreads();
  if (t.active && t.y == 0) {
    for (int yy = 1; yy < rows; ++yy) {
      const int from = (yy * lanes + t.x) * K;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        s[e] += red[0][from + e];
        merge_max(m[e], k[e], red[1][from + e], red[2][from + e]);
      }
    }
    float* out = partial + ((long long)img * gridDim.x + split) * 3 * c + t.x * K;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      out[e] = s[e];
      out[c + e] = m[e];
      out[2 * c + e] = k[e];
    }
  }
}

// K1, second stage: each (image, channel) merges its bands in order: the
// mean and the max in T, the tie count in fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_channel_pool_finish_kernel(const float* __restrict__ partial, T* __restrict__ avg,
                                    T* __restrict__ mx, float* __restrict__ ties, int n, int hw,
                                    int c, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * c) return;
  const long long img = i / c, ch = i % c;
  const float* p = partial + img * splits * 3 * c + ch;
  float s = 0.f, m = -INFINITY, k = 0.f;
  for (int b = 0; b < splits; ++b) {
    s += p[(b * 3) * c];
    merge_max(m, k, p[(b * 3 + 1) * c], p[(b * 3 + 2) * c]);
  }
  avg[i] = from_f32<T>(s / (float)hw);
  mx[i] = from_f32<T>(m);
  ties[i] = k;
}

// B2, first stage: per (image, band), sum over the band's pixels of gx1 * o
// for each channel, into partial (n, splits, c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cbam_channel_bwd_kernel(const T* __restrict__ gx1, const T* __restrict__ o,
                            const float* __restrict__ cg, const T* __restrict__ gc,
                            const float* __restrict__ cmax, const float* __restrict__ ties,
                            float* __restrict__ partial, int hw, int c, int lanes, int rows,
                            int band) {
  constexpr int K = Piece<T>::kN;
  __shared__ float red[kThreads * K];
  const Pool t(lanes, rows);
  const int img = blockIdx.y, split = blockIdx.x;
  const int q0 = split * band, q1 = min(hw, q0 + band);
  float acc[K], cv[K];
#pragma unroll
  for (int e = 0; e < K; ++e) acc[e] = 0.f;
  if (t.active) {
    load_f32<K>(cg + (long long)img * c + t.x * K, cv);
    for (int q = q0 + t.y; q < q1; q += rows) {
      const long long p = (long long)img * hw + q;
      const float a = eoe::to_f32(gc[(long long)img * 2 * hw + q]) / __ldg(ties + p);
      const float b = eoe::to_f32(gc[((long long)img * 2 + 1) * hw + q]) / (float)c;
      const float cm = __ldg(cmax + p);
      float tv[K], ov[K];
      load(gx1 + p * c + t.x * K, tv);
      load(o + p * c + t.x * K, ov);
#pragma unroll
      for (int e = 0; e < K; ++e)
        acc[e] += grad_x1(tv[e], __fmul_rn(ov[e], cv[e]), cm, a, b) * ov[e];
    }
  }
#pragma unroll
  for (int e = 0; e < K; ++e) red[threadIdx.x * K + e] = acc[e];
  __syncthreads();
  if (t.active && t.y == 0) {
    for (int yy = 1; yy < rows; ++yy) {
#pragma unroll
      for (int e = 0; e < K; ++e) acc[e] += red[(yy * lanes + t.x) * K + e];
    }
    float* out = partial + ((long long)img * gridDim.x + split) * c + t.x * K;
#pragma unroll
    for (int e = 0; e < K; ++e) out[e] = acc[e];
  }
}

// B2, second stage: cg's gradient, each (image, channel) summing its bands
// in order.
__global__ void __launch_bounds__(kThreads)
    cbam_channel_bwd_finish_kernel(const float* __restrict__ partial, float* __restrict__ dcg,
                                   int n, int c, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * c) return;
  const float* p = partial + (i / c) * splits * c + i % c;
  float s = 0.f;
  for (int b = 0; b < splits; ++b) s += p[(long long)b * c];
  dcg[i] = s;
}

unsigned finish_blocks(int n, int c) {
  return (unsigned)(((long long)n * c + kThreads - 1) / kThreads);
}

// What every launcher checks: the sizes, the dtype, a piece size that
// divides the channels, and the geometry (ops/cbam.py::row_geometry,
// pool_geometry).
bool bad_head(int n, int hw, int c, int dtype) {
  const int k = dtype == 0 ? 4 : 8;
  return n < 1 || hw < 1 || c < k || c % k != 0 || (dtype != 0 && dtype != 1);
}

bool bad_rows(int lanes, int blocks) {
  return lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || blocks < 1;
}

bool bad_pool(int n, int hw, int c, int dtype, int lanes, int rows, int splits, int band) {
  const int k = dtype == 0 ? 4 : 8;
  return lanes != c / k || lanes > kThreads || rows < 1 || (long long)rows * lanes > kThreads ||
         splits < 1 || band < 1 || (long long)splits * band < hw ||
         (long long)(splits - 1) * band >= hw || n > 65535;
}

template <typename T>
cudaError_t channel_pool(const void* o, float* partial, void* avg, void* mx, float* ties, int n,
                         int hw, int c, int lanes, int rows, int splits, int band,
                         cudaStream_t st) {
  cbam_channel_pool_kernel<T><<<dim3(splits, n), kThreads, 0, st>>>(
      static_cast<const T*>(o), partial, hw, c, lanes, rows, band);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cbam_channel_pool_finish_kernel<T><<<finish_blocks(n, c), kThreads, 0, st>>>(
      partial, static_cast<T*>(avg), static_cast<T*>(mx), ties, n, hw, c, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t channel_bwd(const void* gx1, const void* o, const float* cg, const void* gc,
                        const float* cmax, const float* ties, float* partial, float* dcg, int n,
                        int hw, int c, int lanes, int rows, int splits, int band,
                        cudaStream_t st) {
  cbam_channel_bwd_kernel<T><<<dim3(splits, n), kThreads, 0, st>>>(
      static_cast<const T*>(gx1), static_cast<const T*>(o), cg, static_cast<const T*>(gc), cmax,
      ties, partial, hw, c, lanes, rows, band);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cbam_channel_bwd_finish_kernel<<<finish_blocks(n, c), kThreads, 0, st>>>(partial, dcg, n, c,
                                                                          splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16. Activations (n, hw, c) in memory, 16-byte aligned;
// cg, the (n, c) fp32 maps and the (n, hw) fp32 maps contiguous. Each entry
// launches on `stream` and returns cudaGetLastError() after each launch.

extern "C" int eoe_cbam_channel_pool(const void* o, float* partial, void* avg, void* mx,
                                     float* ties, int n, int hw, int c, int dtype, int lanes,
                                     int rows, int splits, int band, void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_pool(n, hw, c, dtype, lanes, rows, splits, band))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)channel_pool<float>(o, partial, avg, mx, ties, n, hw, c, lanes, rows, splits,
                                    band, st);
  return (int)channel_pool<bf16>(o, partial, avg, mx, ties, n, hw, c, lanes, rows, splits, band,
                                 st);
}

extern "C" int eoe_cbam_spatial_pool(const void* o, const float* cg, void* compress, float* cmax,
                                     float* ties, int n, int hw, int c, int dtype, int lanes,
                                     int blocks, void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_rows(lanes, blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    cbam_spatial_pool_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), cg, static_cast<float*>(compress), cmax, ties, n, hw, c,
        lanes);
  else
    cbam_spatial_pool_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(o), cg, static_cast<bf16*>(compress), cmax, ties, n, hw, c,
        lanes);
  return (int)cudaGetLastError();
}

extern "C" int eoe_cbam_gate(const void* o, const float* cg, const float* sg, const void* r,
                             void* y, int n, int hw, int c, int dtype, int lanes, int blocks,
                             void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_rows(lanes, blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    cbam_gate_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), cg, sg, static_cast<const float*>(r),
        static_cast<float*>(y), n, hw, c, lanes);
  else
    cbam_gate_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(o), cg, sg, static_cast<const bf16*>(r), static_cast<bf16*>(y),
        n, hw, c, lanes);
  return (int)cudaGetLastError();
}

extern "C" int eoe_cbam_gate_bwd(const void* gy, const void* y, const void* o, const float* cg,
                                 const float* sg, void* dr, void* gx1, float* dsg, int n, int hw,
                                 int c, int dtype, int lanes, int blocks, void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_rows(lanes, blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    cbam_gate_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(gy), static_cast<const float*>(y),
        static_cast<const float*>(o), cg, sg, static_cast<float*>(dr), static_cast<float*>(gx1),
        dsg, n, hw, c, lanes);
  else
    cbam_gate_bwd_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(gy), static_cast<const bf16*>(y), static_cast<const bf16*>(o),
        cg, sg, static_cast<bf16*>(dr), static_cast<bf16*>(gx1), dsg, n, hw, c, lanes);
  return (int)cudaGetLastError();
}

extern "C" int eoe_cbam_channel_bwd(const void* gx1, const void* o, const float* cg,
                                    const void* gc, const float* cmax, const float* ties,
                                    float* partial, float* dcg, int n, int hw, int c, int dtype,
                                    int lanes, int rows, int splits, int band, void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_pool(n, hw, c, dtype, lanes, rows, splits, band))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)channel_bwd<float>(gx1, o, cg, gc, cmax, ties, partial, dcg, n, hw, c, lanes,
                                   rows, splits, band, st);
  return (int)channel_bwd<bf16>(gx1, o, cg, gc, cmax, ties, partial, dcg, n, hw, c, lanes, rows,
                                splits, band, st);
}

extern "C" int eoe_cbam_input_bwd(const void* gx1, const void* o, const float* cg,
                                  const void* gc, const float* cmax, const float* ties,
                                  const void* mx, const float* mx_ties, const float* gmx,
                                  const float* gavg, void* go, int n, int hw, int c, int dtype,
                                  int lanes, int blocks, void* stream) {
  if (bad_head(n, hw, c, dtype) || bad_rows(lanes, blocks)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    cbam_input_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(gx1), static_cast<const float*>(o), cg,
        static_cast<const float*>(gc), cmax, ties, static_cast<const float*>(mx), mx_ties, gmx,
        gavg, static_cast<float*>(go), n, hw, c, lanes);
  else
    cbam_input_bwd_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(gx1), static_cast<const bf16*>(o), cg,
        static_cast<const bf16*>(gc), cmax, ties, static_cast<const bf16*>(mx), mx_ties, gmx,
        gavg, static_cast<bf16*>(go), n, hw, c, lanes);
  return (int)cudaGetLastError();
}
