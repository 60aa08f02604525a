// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// in fp32, stored in x's dtype; and the same norm fused with the residual
// add that precedes it in the model, s = x + y (stored in x's dtype) and
// rmsnorm(s), where the norm reads the rounded s, so the residual stream is
// bit for bit PyTorch's `x + y`.
//
// Replaces the Pallas kernel `rmsnorm_kernel` of src/repro/kernels/rmsnorm.py.
//
// Bound: device-memory bytes (one row reduction and an elementwise scale;
// 4 operations an element). So each row is read once and written once:
// a block of 256 threads holds a whole row in registers, issuing all of
// its 16-byte loads (8 bf16 or 4 fp32 values) before the reduction; the
// fp32 sum of squares is taken by warp shuffles and then one shared-memory
// step across the 8 warps. The weight is loaded once per block and reused
// for every row the block takes. The grid is min(rows, SMs x resident
// blocks an SM), each block stepping over rows with the grid's stride, so a
// decode step's 8 rows take 8 SMs and a prefill chunk's 4096 rows spread
// over every SM at full occupancy; there a block's next row is loaded
// while this one is reduced and stored, so each block keeps two rows in
// flight. At the decode shape the call is bound by its launch and one
// round trip to memory, which the fused add shares with the norm instead
// of paying it in a launch of its own.
//
// Widths: d a multiple of 16 / sizeof(T) takes the 16-byte path; any other
// d takes one element a load. A row is held as NV loads a thread, NV in
// {1, 2, 4, 8}: d <= 2048 x 16 / sizeof(T) on the 16-byte path (16384 bf16
// values), d <= 2048 otherwise.
#include "common.cuh"

namespace {

using repro::store;
using repro::to_f;
using repro::warp_sum;

constexpr int kThreads = 256;

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T>
__device__ __forceinline__ T round_to(float f) {
  T r;
  store(&r, f);
  return r;
}

// ADD: sum_out = x + y (rounded to T), out = rmsnorm(sum_out); else
// out = rmsnorm(x) (y and sum_out unused). All (rows, d), w (d,).
template <typename T, int VW, int NV, bool ADD>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ y,
               const T* __restrict__ w, T* __restrict__ sum_out,
               T* __restrict__ out, int rows, int d, float eps) {
  using P = Pack<T, VW>;
  // the next row's loads are issued before this row's reduction, where the
  // registers allow it
  constexpr bool PREFETCH = NV <= 4;
  const int nvec = d / VW, tid = threadIdx.x;
  __shared__ float red[kThreads / 32];
  P wv[NV], xv[NV], yv[NV];
  auto load = [&](int row, P (&xd)[NV], P (&yd)[NV]) {
    const size_t off = (size_t)row * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tid + j * kThreads;
      if (c < nvec) {
        xd[j] = reinterpret_cast<const P*>(x + off)[c];
        if (ADD) yd[j] = reinterpret_cast<const P*>(y + off)[c];
      }
    }
  };
  if ((int)blockIdx.x < rows) load(blockIdx.x, xv, yv);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = tid + j * kThreads;
    if (c < nvec) wv[j] = reinterpret_cast<const P*>(w)[c];
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * d;
    const int next = row + gridDim.x;
    P xn[NV], yn[NV];
    if (PREFETCH && next < rows) load(next, xn, yn);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tid + j * kThreads;
      if (c < nvec) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (ADD)
            xv[j].v[e] = round_to<T>(to_f(xv[j].v[e]) + to_f(yv[j].v[e]));
          const float f = to_f(xv[j].v[e]);
          ss = fmaf(f, f, ss);
        }
        if (ADD) reinterpret_cast<P*>(sum_out + off)[c] = xv[j];
      }
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += red[i];
    __syncthreads();  // red is free for the next row
    const float r = rsqrtf(tot / (float)d + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = tid + j * kThreads;
      if (c < nvec) {
        P o;
#pragma unroll
        for (int e = 0; e < VW; ++e)
          o.v[e] = round_to<T>(to_f(xv[j].v[e]) * r *
                               (1.f + to_f(wv[j].v[e])));
        reinterpret_cast<P*>(out + off)[c] = o;
      }
    }
    if (next < rows) {
      if (!PREFETCH) load(next, xn, yn);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        xv[j] = xn[j];
        if (ADD) yv[j] = yn[j];
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <typename T, int VW, int NV, bool ADD>
int launch(const void* x, const void* y, const void* w, void* sum_out,
           void* out, int rows, int d, float eps, cudaStream_t stream) {
  auto kern = rmsnorm_kernel<T, VW, NV, ADD>;
  static int resident = 0;  // blocks an SM holds at once
  if (resident == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kern, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int grid = rows < sms * resident ? rows : sms * resident;
  kern<<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)y, (const T*)w,
                                      (T*)sum_out, (T*)out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool ADD>
int dispatch(const void* x, const void* y, const void* w, void* sum_out,
             void* out, int rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int V = 16 / sizeof(T);
  const bool wide = d % V == 0;
  const int per = kThreads * (wide ? V : 1);  // values a block holds per NV
#define REPRO_NORM_NV(NV_)                                                  \
  if (d <= NV_ * per)                                                       \
    return wide ? launch<T, V, NV_, ADD>(x, y, w, sum_out, out, rows, d,    \
                                         eps, s)                            \
                : launch<T, 1, NV_, ADD>(x, y, w, sum_out, out, rows, d,    \
                                         eps, s);
  if (d <= 0) return (int)cudaErrorInvalidValue;
  REPRO_NORM_NV(1)
  REPRO_NORM_NV(2)
  REPRO_NORM_NV(4)
  REPRO_NORM_NV(8)
#undef REPRO_NORM_NV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: (rows, d); w: (d,). Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm(int dtype, const void* x, const void* w, void* out,
                       int rows, int d, float eps, void* stream) {
  if (dtype == 0)
    return dispatch<float, false>(x, nullptr, w, nullptr, out, rows, d, eps,
                                  stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(x, nullptr, w, nullptr, out, rows,
                                          d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

// sum_out = x + y in x's dtype, out = rmsnorm(sum_out); x, y, sum_out, out:
// (rows, d); w: (d,).
extern "C" int add_rmsnorm(int dtype, const void* x, const void* y,
                           const void* w, void* sum_out, void* out, int rows,
                           int d, float eps, void* stream) {
  if (dtype == 0)
    return dispatch<float, true>(x, y, w, sum_out, out, rows, d, eps, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, true>(x, y, w, sum_out, out, rows, d, eps,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
