// RG-LRU linear recurrence for Hopper (sm_90a), in fp32:
// h_t = a_t * h_{t-1} + bx_t over t, independently in every width lane.
//
// Replaces the Pallas kernel `rglru_scan_kernel` of
// src/repro/kernels/rglru_scan.py.
//
// Bound: device-memory bytes. Each element of a and bx is read once and each
// h_t written once (3 T W floats), with one fused multiply-add per element.
// The recurrence is sequential in t, so a thread owns one width lane and
// walks t in order; neighbouring threads own neighbouring lanes, so every
// load and store of a warp is one 128-byte row segment. To keep enough bytes
// in flight, a thread first loads kUnroll steps of a and bx into registers,
// then runs the kUnroll fused multiply-adds and stores. Lanes past W (the
// ragged tail of the last block) are masked; there is no W % block rule.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 32;

// a, bx, y: (B, T, W); h0, hT: (B, W). Grid (ceil(W / kThreads), B).
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ hT, int T, int W) {
  const int b = blockIdx.y, w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)b * T * W + w;
  float h = h0[(size_t)b * W + w];
  for (int t0 = 0; t0 < T; t0 += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      av[u] = t < T ? a[base + (size_t)t * W] : 0.f;
      xv[u] = t < T ? bx[base + (size_t)t * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < T) {
        h = fmaf(av[u], h, xv[u]);
        y[base + (size_t)t * W] = h;
      }
    }
  }
  hT[(size_t)b * W + w] = h;
}

}  // namespace

// All operands fp32 and contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int rglru_scan(const void* a, const void* bx, const void* h0,
                          void* y, void* hT, int B, int T, int W,
                          void* stream) {
  if (B <= 0 || T <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  scan_kernel<<<dim3((W + kThreads - 1) / kThreads, B), kThreads, 0,
                (cudaStream_t)stream>>>((const float*)a, (const float*)bx,
                                        (const float*)h0, (float*)y,
                                        (float*)hT, T, W);
  return (int)cudaGetLastError();
}
