// Fused QKV multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel eoe_tpu/ops/attention.py::_fwd_compute (with
// _fwd_group_math and _cell_bias), reached there through fused_qkv_attention.
// Both CLIP encoders run every transformer block through it: the image side at
// s=50, 12 heads, d=64 with no mask, the text side at s=77, 8 heads, d=64,
// causal.
//
// Input is the un-transposed joint projection qkv (n, s, 3*H*d), columns
// ordered [q | k | v] with heads contiguous inside each; output is (n, s, H*d)
// with heads concatenated. Nothing is transposed, padded or copied in HBM: a
// block loads its head's q, k and v strided straight from qkv.
//
// Numerics follow _fwd_group_math: logits in fp32 times d^-1/2 (for d=64 the
// TPU kernel pre-scales q by 2^-3 in the input dtype, which is exact, so the
// product is the same), masked keys at -1e30, fp32 softmax, P rounded to the
// input dtype before P.V, P.V accumulated in fp32 and cast to the input dtype.
//
// What bounds it on this card: at CLIP's shapes the function moves
// n*s*4*H*d elements (read qkv once, write the output once) and does
// 4*n*H*s^2*d operations, about 25 per byte in bf16, far under the ~295 the
// H100 needs before its tensor cores are the limit: it is bound by bytes. This
// first version is the simple correct design: one block per (image, head), the
// three s x d tiles in shared memory (one padding word per row, so a warp
// reading one column across 32 rows hits 32 banks), one warp per query row,
// CUDA-core fp32 FMAs for both products. It reads each qkv byte once and
// writes each output byte once, so its HBM traffic is the bound's; what it
// does not yet do is keep enough bytes in flight (no cp.async/TMA pipeline)
// or use the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 128;                 // one tile covers the sequence
constexpr int kKeysPerLane = kMaxSeq / 32;
constexpr float kMasked = -1e30f;            // the TPU kernel's additive bias

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int s, int heads,
                     int causal, float scale) {
  using Tl = Tile<T, D>;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
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

constexpr int kMaxDevices = 64;

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, int n, int s, int heads, int causal, float scale,
                   cudaStream_t stream) {
  auto kernel = fused_qkv_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>(s);
  if (smem > 48 * 1024) {
    // Above 48 KB a kernel must opt in. Raise its cap once per device, to
    // what the longest sequence needs, instead of on every launch.
    static std::atomic<bool> raised[kMaxDevices];
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!raised[device].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes<T, D>(kMaxSeq));
      if (err != cudaSuccess) return err;
      raised[device].store(true, std::memory_order_release);
    }
  }
  kernel<<<n * heads, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                                s, heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// Launches on `stream`, which must belong to the current device (the caller
// sets it), and does not synchronise.
extern "C" int eoe_fused_qkv_attention_fwd(const void* qkv, void* out, int n, int s, int heads,
                                           int d, int dtype, int causal, float scale,
                                           void* stream) {
  if (n < 1 || s < 1 || s > kMaxSeq || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64) return (int)launch<float, 64>(qkv, out, n, s, heads, causal, scale, st);
  if (dtype == 0 && d == 128) return (int)launch<float, 128>(qkv, out, n, s, heads, causal, scale, st);
  if (dtype == 1 && d == 64)
    return (int)launch<__nv_bfloat16, 64>(qkv, out, n, s, heads, causal, scale, st);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16, 128>(qkv, out, n, s, heads, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* eoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
