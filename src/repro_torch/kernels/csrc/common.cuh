// Device helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the masked score of the JAX package

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// Stage two ROWS x HD tiles (K and V, rows `row_stride` elements apart in
// device memory) into shared memory as fp32, with leading dims ldk / ldv.
// Rows >= n read as 0. Every thread first issues all of its 16-byte loads,
// then converts and stores, so the loads of a tile are in flight together.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           size_t row_stride, int n,
                                           float* da, int lda, float* db,
                                           int ldb, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  static_assert(HD % VEC == 0, "head_dim must fill 16-byte vectors");
  uint4 ra[ITERS], rb[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = tid + it * THREADS;
    const int row = c / PER_ROW, col = (c % PER_ROW) * VEC;
    ra[it] = rb[it] = make_uint4(0u, 0u, 0u, 0u);
    if (c < TOTAL && row < n) {
      const size_t off = (size_t)row * row_stride + col;
      ra[it] = *reinterpret_cast<const uint4*>(a + off);
      if (b != nullptr) rb[it] = *reinterpret_cast<const uint4*>(b + off);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = tid + it * THREADS;
    if (c >= TOTAL) continue;
    const int row = c / PER_ROW, col = (c % PER_ROW) * VEC;
    const T* va = reinterpret_cast<const T*>(&ra[it]);
    const T* vb = reinterpret_cast<const T*>(&rb[it]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      da[row * lda + col + e] = to_f(va[e]);
      if (db != nullptr) db[row * ldb + col + e] = to_f(vb[e]);
    }
  }
}

}  // namespace repro
