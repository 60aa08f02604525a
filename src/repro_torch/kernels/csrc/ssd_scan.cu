// Mamba2 SSD intra-chunk term for Hopper (sm_90a), in fp32.
//
// Replaces the Pallas kernel `ssd_intra_kernel` of
// src/repro/kernels/ssd_scan.py. Per (batch b, chunk c, head h), with
// X = xdt[b, c, :, h, :] (Q x P) and ca = cum_a[b, c, :, h]:
//
//   y[i, :] = sum_{j <= i} (C_i . B_j) exp(ca_i - ca_j) X[j, :]    (Q x P)
//   s[:, n] = sum_j X[j, :] B_j[n] exp(ca_{Q-1} - ca_j)              (P x N)
//
// Bound: device-memory bytes at the shapes of mamba2-2.7b (Q 256, H 80,
// P 64, N 128): about 0.7 GFLOP per chunk against 13 MB moved is below the
// card's operations-per-byte line even at the TF32 tensor-core rate. This
// first version multiplies in fp32 on CUDA cores, so in practice it is bound
// by its own arithmetic; TF32 wgmma products are later work.
//
// Design. C.B^T depends on (b, c) and not on the head, so it is computed
// once per chunk by `cb_kernel` (lower triangle only, 64 x 64 tiles, a 4 x 4
// register tile per thread) into a (B*nc, Q, Q) scratch that stays in L2.
// `intra_kernel` then runs one block per (head, b*nc): it stages X (Q x P)
// and ca in shared memory once, and
//   * for each tile of 64 query rows builds W = CB o L for the visible keys
//     in shared memory and takes y = W X (a 4 x 4 register tile per thread);
//   * for each tile of 64 keys stages B o exp(ca_end - ca) in shared memory
//     and accumulates s^T = X^T (B o decay) (a 4 x 8 register tile).
// Products above the diagonal are never formed. The exponents are <= 0 on
// every visible pair (cum_a is a cumulative sum of non-positive log-decays).
// Q <= 256, P <= 64, N <= 128; ragged edges are masked.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // rows of a CB tile, a W tile and a B tile
constexpr int kK = 32;       // N-slice of the CB product staged per step
constexpr int kMaxQ = 256, kMaxP = 64, kMaxN = 128;

// cb[z, i, j] = sum_n Cr[z, i, n] Br[z, j, n] for j <= i (tiles wholly above
// the diagonal are skipped; nothing reads them). Grid (Q/64, Q/64, B*nc).
__global__ void __launch_bounds__(kThreads)
cb_kernel(const float* __restrict__ Cr, const float* __restrict__ Br,
          float* __restrict__ cb, int Q, int N) {
  const int ti = blockIdx.x, tj = blockIdx.y, z = blockIdx.z;
  if (tj > ti) return;
  __shared__ float Cs[kTile][kK + 1];
  __shared__ float Bs[kTile][kK + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* cz = Cr + (size_t)z * Q * N;
  const float* bz = Br + (size_t)z * Q * N;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kK) {
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, c = e % kK, n = n0 + c;
      const int i = ti * kTile + r, j = tj * kTile + r;
      Cs[r][c] = (i < Q && n < N) ? cz[(size_t)i * N + n] : 0.f;
      Bs[r][c] = (j < Q && n < N) ? bz[(size_t)j * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kK; ++c) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = Cs[ty + 16 * a][c];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[tx + 16 * b][c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti * kTile + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj * kTile + tx + 16 * b;
      if (i < Q && j < Q) cb[((size_t)z * Q + i) * Q + j] = acc[a][b];
    }
  }
}

size_t intra_smem_floats(int Q) {
  const size_t w = (size_t)kTile * (Q + 1), bt = (size_t)kTile * kMaxN;
  return (size_t)Q * kMaxP + Q + (w > bt ? w : bt);
}

// Grid (H, B*nc). xdt/y: (B*nc, Q, H, P); cum_a: (B*nc, Q, H);
// Br: (B*nc, Q, N); cb: (B*nc, Q, Q); s: (B*nc, H, P, N).
__global__ void __launch_bounds__(kThreads)
intra_kernel(const float* __restrict__ xdt, const float* __restrict__ cum_a,
             const float* __restrict__ Br, const float* __restrict__ cb,
             float* __restrict__ y, float* __restrict__ s, int Q, int H,
             int P, int N) {
  const int h = blockIdx.x, z = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  extern __shared__ float smem[];
  float* Xs = smem;                   // Q x kMaxP, columns >= P zero
  float* ca = Xs + (size_t)Q * kMaxP; // Q
  float* Ws = ca + Q;                 // W tile (kTile x ldw), then B tiles
  const int ldw = Q + 1;

  for (int e = tid; e < Q * kMaxP; e += kThreads) {
    const int j = e / kMaxP, p = e % kMaxP;
    Xs[e] = p < P ? xdt[(((size_t)z * Q + j) * H + h) * P + p] : 0.f;
  }
  for (int j = tid; j < Q; j += kThreads) ca[j] = cum_a[((size_t)z * Q + j) * H + h];
  __syncthreads();

  // y = (CB o L) X, one tile of kTile query rows at a time
  const float* cbz = cb + (size_t)z * Q * Q;
  for (int i0 = 0; i0 < Q; i0 += kTile) {
    const int jmax = min(Q, i0 + kTile);   // keys any row of the tile sees
    for (int e = tid; e < kTile * jmax; e += kThreads) {
      const int r = e / jmax, j = e % jmax, i = i0 + r;
      Ws[r * ldw + j] = (i < Q && j <= i)
          ? cbz[(size_t)i * Q + j] * expf(ca[i] - ca[j]) : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int j = 0; j < jmax; ++j) {
      float wv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) wv[a] = Ws[(ty + 16 * a) * ldw + j];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = Xs[j * kMaxP + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(wv[a], xv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx + 16 * b;
        if (i < Q && p < P) y[(((size_t)z * Q + i) * H + h) * P + p] = acc[a][b];
      }
    }
    __syncthreads();  // the tile's shared reads are done before the next build
  }

  // s^T = X^T (B o exp(ca_end - ca)), one tile of kTile keys at a time
  const float ca_end = ca[Q - 1];
  const float* bz = Br + (size_t)z * Q * N;
  float acc[4][8] = {};
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    const int nj = min(kTile, Q - j0);
    for (int e = tid; e < kTile * kMaxN; e += kThreads) {
      const int jj = e / kMaxN, n = e % kMaxN, j = j0 + jj;
      Ws[e] = (jj < nj && n < N)
          ? bz[(size_t)j * N + n] * expf(ca_end - ca[j]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      float xv[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = Xs[(j0 + jj) * kMaxP + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 8; ++b) bv[b] = Ws[jj * kMaxN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* sz = s + ((size_t)z * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = tx + 16 * b;
      if (p < P && n < N) sz[(size_t)p * N + n] = acc[a][b];
    }
  }
}

}  // namespace

// xdt (Z, Q, H, P), cum_a (Z, Q, H), Br/Cr (Z, Q, N), all fp32, Z = B * nc;
// cb is a (Z, Q, Q) fp32 scratch; outputs y (Z, Q, H, P), s (Z, H, P, N).
// Returns cudaGetLastError() after the two launches.
extern "C" int ssd_intra(const void* xdt, const void* cum_a, const void* Br,
                         const void* Cr, void* cb, void* y, void* s, int Z,
                         int Q, int H, int P, int N, void* stream) {
  if (Z <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (Q + kTile - 1) / kTile;
  cb_kernel<<<dim3(nt, nt, Z), kThreads, 0, st>>>(
      (const float*)Cr, (const float*)Br, (float*)cb, Q, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * intra_smem_floats(Q);
  err = cudaFuncSetAttribute(intra_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  intra_kernel<<<dim3(H, Z), kThreads, smem, st>>>(
      (const float*)xdt, (const float*)cum_a, (const float*)Br,
      (const float*)cb, (float*)y, (float*)s, Q, H, P, N);
  return (int)cudaGetLastError();
}
