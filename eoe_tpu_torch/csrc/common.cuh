// Helpers shared by the port's CUDA sources: element conversions, warp
// reductions, the error string, the opt-in to more than 48 KB of dynamic
// shared memory, the Hopper instructions the tensor-core kernels use
// (cp.async, ldmatrix, mma.sync) and the fp32 register-tiled products. Each
// source includes this file once and is built into a library of its own
// (ops/_build.py), so the definitions do not collide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace eoe {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Round to the element type and back: the TPU kernels' casts of P and dS.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

constexpr int kMaxDevices = 64;

// Above 48 KB a kernel must opt in to dynamic shared memory. Raise its cap
// once per device, to what its largest shape needs (`cap`), instead of on
// every launch. `raised` is the caller's per-kernel flag array.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t need, size_t cap, std::atomic<bool>* raised) {
  if (need <= 48 * 1024) return cudaSuccess;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
    if (err != cudaSuccess) return err;
    raised[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- Hopper instructions

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1; with src_bytes = 0 it writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives its (l / 4, 2 (l % 4) .. +1) pair of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The same, each matrix transposed: the lane receives (2 (l % 4) .. +1, l / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a (16x16, row-major fragment) . b (16x8, column fragment), fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc (16 x 8 n-tiles of fp32 fragments) = A . B^T over D columns, A's 16
// rows at a, B's 16 * NB rows at b, both row-major with a pitch of P
// elements; the n-tile j covers B rows 8j .. 8j + 7.
template <int D, int NB, int P>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NB][4], const bf16* a, const bf16* b) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < 2 * NB; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_addr(a + (lane % 16) * P + kk * 16 + (lane / 16) * 8));
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_addr(b + (t * 16 + lane % 8 + (lane / 16) * 8) * P + kk * 16 +
                            (lane / 8 % 2) * 8));
      mma_bf16(acc[2 * t], af, bf[0], bf[1]);
      mma_bf16(acc[2 * t + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D, D/8 n-tiles) += A . V over 16 * K16 contraction rows: A given
// as packed fragments, one per 16 rows; V's rows at v (pitch P).
template <int D, int K16, int P>
__device__ __forceinline__ void mma_av(float (&acc)[D / 8][4], const uint32_t (&a)[K16][4],
                                       const bf16* v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < K16; ++t) {
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_addr(v + (t * 16 + lane % 8 + (lane / 8 % 2) * 8) * P + dn * 16 +
                              (lane / 16) * 8));
      mma_bf16(acc[2 * dn], a[t], bf[0], bf[1]);
      mma_bf16(acc[2 * dn + 1], a[t], bf[2], bf[3]);
    }
  }
}

// Start the copy of a (rows, D) tile into shared memory with a pitch of P
// elements, 16 bytes at a time by NT threads: row j of it from
// src + j * row_stride elements, columns [0, ncols) (a multiple of 16 bytes);
// rows from `real` to `rows` and columns past `ncols` become zeros.
template <typename T, int D, int P, int NT>
__device__ __forceinline__ void tile_load(T* tile, const T* src, long long row_stride, int rows,
                                          int real, int ncols) {
  constexpr int E = 16 / (int)sizeof(T);             // elements of one 16-byte chunk
  constexpr int kChunks = D / E;
  for (int i = threadIdx.x; i < rows * kChunks; i += NT) {
    const int j = i / kChunks, c = i % kChunks;
    const bool ok = j < real && c * E < ncols;
    cp_async16(smem_addr(tile + j * P + c * E), src + (ok ? j * row_stride + c * E : 0),
               ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------- fp32 register tiles
//
// fp32 products on CUDA cores with each shared-memory load feeding several
// FMAs: a warp takes four query rows at a time; for QK^T lane l owns keys
// l, l + 32, ..., reading each key row as float4 (4 FMAs for each row of
// the quad) against the quad's float4 q (one broadcast load for the lanes);
// for P.V lane l owns D/32 adjacent output columns of the four rows, and
// P comes as one broadcast float4 per key (the four rows' probabilities).
// Tiles have a pitch of D + 4 floats, so that the eight rows one
// quarter-warp reads sit in eight distinct 16-byte bank groups.

template <int D>
struct F32Tile {
  static constexpr int kPitch = D + 4;
};

// x[i][c] = q_i . k_(lane + 32 c) for c < nch (uniform over the warp): the
// four rows at row(0..3) (a callable giving each row's 16-byte aligned
// address, in shared or global memory) against the key rows at k, of pitch
// D + 4. Sums run over the columns in order, so the same two rows give the
// same bits whichever side they are on.
template <int D, int NC, typename Rows>
__device__ __forceinline__ void f32_qk_rows(float (&x)[4][NC], Rows row, const float* k,
                                            int nch) {
  constexpr int P = F32Tile<D>::kPitch;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) x[i][c] = 0.f;
#pragma unroll 4
  for (int c4 = 0; c4 < D; c4 += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(row(i) + c4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nch) {
        const float4 kv = *reinterpret_cast<const float4*>(k + (lane + 32 * c) * P + c4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i][c] = fmaf(qv[i].x, kv.x, x[i][c]);
          x[i][c] = fmaf(qv[i].y, kv.y, x[i][c]);
          x[i][c] = fmaf(qv[i].z, kv.z, x[i][c]);
          x[i][c] = fmaf(qv[i].w, kv.w, x[i][c]);
        }
      }
    }
  }
}

// The same with the four rows at q, of pitch D + 4.
template <int D, int NC>
__device__ __forceinline__ void f32_qk(float (&x)[4][NC], const float* q, const float* k,
                                       int nch) {
  f32_qk_rows<D, NC>(x, [q](int i) { return q + i * F32Tile<D>::kPitch; }, k, nch);
}

// acc[i][u] += sum_(j < n) p[j].i * v_j[lane * D/32 + u], in key order:
// p holds the quad's four probabilities of each key, v the value rows
// (pitch D + 4).
template <int D>
__device__ __forceinline__ void f32_pv(float (&acc)[4][D / 32], const float4* p, const float* v,
                                       int n) {
  constexpr int P = F32Tile<D>::kPitch;
  constexpr int U = D / 32;
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < n; ++j) {
    const float4 pj = p[j];
    float vv[U];
    const float* vr = v + j * P + lane * U;
    if constexpr (U == 4) {
      const float4 t = *reinterpret_cast<const float4*>(vr);
      vv[0] = t.x, vv[1] = t.y, vv[2] = t.z, vv[3] = t.w;
    } else if constexpr (U == 2) {
      const float2 t = *reinterpret_cast<const float2*>(vr);
      vv[0] = t.x, vv[1] = t.y;
    } else {
      vv[0] = vr[0];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[0][u] = fmaf(pj.x, vv[u], acc[0][u]);
      acc[1][u] = fmaf(pj.y, vv[u], acc[1][u]);
      acc[2][u] = fmaf(pj.z, vv[u], acc[2][u]);
      acc[3][u] = fmaf(pj.w, vv[u], acc[3][u]);
    }
  }
}

// Store row i of a quad's acc (D/32 columns a lane) to dst, columns below ncols.
template <int D>
__device__ __forceinline__ void f32_store_row(float* dst, const float (&acc)[D / 32], int ncols) {
  constexpr int U = D / 32;
  const int c = (threadIdx.x % 32) * U;
  if (c >= ncols) return;
  if constexpr (U == 4) {
    *reinterpret_cast<float4*>(dst + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (U == 2) {
    *reinterpret_cast<float2*>(dst + c) = make_float2(acc[0], acc[1]);
  } else {
    dst[c] = acc[0];
  }
}

// Shared memory of f32_attend_head: the q, k and v tiles of rows padded to a
// multiple of 32 (the keys a lane's chunks read) and each warp's float4
// probabilities of its current quad.
template <int D, int NT>
size_t f32_head_smem(int s) {
  const size_t rows = (s + 31) / 32 * 32;
  return rows * (3 * F32Tile<D>::kPitch * sizeof(float) + NT / 32 * sizeof(float4));
}

// The fp32 attention of one (image, head) on the register tiles, the whole
// sequence (s <= 128) resident in shared memory, by a block of NT threads:
// q, k and v (rows of their row strides apart, columns [0, ncols) of D, the
// rest zero) come in by cp.async; each warp takes quads of query rows in
// turn: QK^T, logit(r, key, q.k) for the final logit of every key a lane
// owns (masked and padded keys at a value whose exp is 0; a row of -inf
// gives NaN), the fp32 softmax with the row max subtracted, P normalised by
// the sum's reciprocal, P.V over the keys in order, the rows below s stored.
// With `causal`, a quad reads only the keys its last row may attend to.
template <int D, int NT, typename Logit>
__device__ __forceinline__ void f32_attend_head(const float* q, long long q_row, const float* k,
                                                long long k_row, const float* v, long long v_row,
                                                float* out, long long out_row, int s, int ncols,
                                                bool causal, Logit logit, uint32_t* smem) {
  constexpr int P = F32Tile<D>::kPitch, NC = 4;       // 4 chunks of 32 keys: s <= 128
  const int rows = (s + 31) / 32 * 32;               // zero-filled past s
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + rows * P;
  float* Vs = Ks + rows * P;
  tile_load<float, D, P, NT>(Qs, q, q_row, rows, s, ncols);
  tile_load<float, D, P, NT>(Ks, k, k_row, rows, s, ncols);
  tile_load<float, D, P, NT>(Vs, v, v_row, rows, s, ncols);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* pw = reinterpret_cast<float4*>(Vs + rows * P) + warp * rows;
  for (int r0 = 4 * warp; r0 < s; r0 += NT / 8) {     // NT / 32 warps, four rows each
    const int n_max = causal ? min(r0 + 4, s) : s;    // keys the quad's last row sees
    const int nch = (n_max + 31) / 32;                // uniform across the warp
    float x[4][NC], m[4], inv[4];
    f32_qk<D, NC>(x, Qs + r0 * P, Ks, nch);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[i][c] = logit(r0 + i, lane + 32 * c, x[i][c]);
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
    for (int c = 0; c < NC; ++c) {
      if (c < nch)
        pw[lane + 32 * c] = make_float4(x[0][c] * inv[0], x[1][c] * inv[1], x[2][c] * inv[2],
                                        x[3][c] * inv[3]);
    }
    __syncwarp();

    float acc[4][D / 32];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < D / 32; ++u) acc[i][u] = 0.f;
    f32_pv<D>(acc, pw, Vs, n_max);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < s) f32_store_row<D>(out + (r0 + i) * out_row, acc[i], ncols);
    __syncwarp();  // pw is rewritten by this warp's next quad
  }
}

}  // namespace eoe

// The message of a cudaError_t that a launcher returned.
extern "C" const char* eoe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
