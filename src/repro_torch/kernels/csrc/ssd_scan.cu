// Mamba2 SSD intra-chunk term for Hopper (sm_90a): fp32 in and out, every
// product on the TF32 tensor cores with the 3xTF32 split.
//
// Replaces the Pallas kernel `ssd_intra_kernel` of
// src/repro/kernels/ssd_scan.py. Per (batch b, chunk c, head h), with
// X = xdt[b, c, :, h, :] (Q x P) and ca = cum_a[b, c, :, h]:
//
//   y[i, :] = sum_{j <= i} (C_i . B_j) exp(ca_i - ca_j) X[j, :]    (Q x P)
//   s[:, n] = sum_j X[j, :] B_j[n] exp(ca_{Q-1} - ca_j)              (P x N)
//
// Bound: device-memory bytes at mamba2-2.7b's widths (H 80, P 64, N 128):
// at the serving chunk (Q 16) mostly the 2.6 MB of s; at the config's
// chunk (two of Q 256) 27 MB against 1.4 GFLOP, under the TF32 rate's
// operations-per-byte line. In fp32 on CUDA cores the products would bound
// it instead, so they run on the tensor cores, and nothing but the inputs
// and the outputs goes through device memory.
//
// One launch, no scratch. The grid has two kinds of 128-thread blocks:
//   * y blocks, one per (z, 16*WR query rows, HB = (4/WR)*G heads). Warp
//     (wr, wh) owns 16 query rows and G heads. For each staged tile of 32
//     keys it forms C.B^T (16 x 32, K = N) in registers, then for each of
//     its heads the decay mask W = CB o exp(ca_i - ca_j) (j <= i, else 0)
//     in registers, and y += W X. The G heads of a warp share its C.B^T.
//     Key tiles wholly above the warp's rows are never formed.
//   * s blocks, one per (z, head, 64 state columns): warp w owns rows
//     [16w, 16w + 16) of s = (X o decay_end)^T B over all keys.
// The host picks WR (warps along the rows: 1 for Q <= 16, 2 for Q <= 32,
// else 4) and G (heads a warp: 2 for Q > 64, else 1), so both the serving
// chunk and the config's chunk give a few hundred blocks. y blocks come
// first in the grid, the ones with the most keys first.
//
// Products: mma.sync.m16n8k8 tf32 with fp32 accumulation. Each operand is
// split as big = tf32(a) and small = a - big, and each product taken as
// a_small b_big + a_big b_small, then a_big b_big: fp32-accurate (a single
// TF32 pass misses 1e-4 x max|plain|, tests/test_torch_kernels.py). The
// CB accumulator goes straight into the A operand of W X: the 8 keys of an
// n8 tile are taken in the order (2t, 2t+1) -> k slots (t, t + 4), and the
// X rows are read in the same order, so no shuffle is needed.
//
// Staging: cp.async (16 bytes where P and N are multiples of 4 floats and
// the pointers are aligned, else 4 bytes an element) into a ring of key
// tiles; rows past Q and columns past P or N are zero-filled in shared
// memory, and the products run over the full padded widths, so their inner
// loops have no branches. Leading dimensions are 4 mod 32 floats where a fragment reads
// (row g, column t) and 8 mod 32 where it reads (row t, column g), so the
// fragment loads touch 32 distinct banks. Masks are by index, never by
// value: a padded row or key gives 0, never inf * 0.
//
// Q <= 256, P <= 64, N <= 128, any Q from 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kKT = 32;                  // keys a staged tile
constexpr int kNW = 64;                  // state columns an s block
constexpr int kMaxQ = 256, kMaxP = 64, kMaxN = 128;
constexpr int kLdC = kMaxN + 4;          // C rows and B tiles (y blocks)
constexpr int kLdXY = kMaxP + 4;         // X tiles of the y blocks
constexpr int kLdS = kNW + 8;            // X and B tiles of the s blocks
// Key tiles in flight: one in a y block (three y blocks then fit an SM in
// registers and shared memory, which beat two double-buffered ones), three
// in an s block (its share of the launch's shared memory holds them).
constexpr int kYStages = 1, kSStages = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !ok (nothing is read).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` x `cols` floats (cols a multiple of 4) into dst (leading dim
// ld); row r comes from src + r * stride. Rows >= nr and columns >= nc are
// zero-filled; src must be a valid address even when nr is 0.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t stride, int rows, int cols,
                                      int nr, int nc, bool vec, int tid) {
  if (vec) {
    const int cpr = cols / 4;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = (e % cpr) * 4;
      const bool ok = r < nr && c < nc;
      cp16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      const bool ok = r < nr && c < nc;
      cp4(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// x = big + small. big is x rounded to TF32 (to nearest, ties away: the
// rounding of cvt.rna.tf32.f32, in two integer ops); small = x - big is
// exact, and the tensor core reads its top 19 bits. Together they carry x
// to ~fp32 precision.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d (16x8) += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to fp32 accuracy: the small cross terms first, then big x big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// Shared floats of a y block whose keys are [0, jend) and of an s block.
inline int y_smem_floats(int WR, int HB, int jend) {
  const int nt = (jend + kKT - 1) / kKT, stages = nt < kYStages ? nt : kYStages;
  return 16 * WR * kLdC + HB * nt * kKT +
         stages * kKT * (kLdC + HB * kLdXY);
}

inline int s_smem_floats(int Q) {
  const int nt = (Q + kKT - 1) / kKT, stages = nt < kSStages ? nt : kSStages;
  return nt * kKT + stages * kKT * 2 * kLdS;
}

// cb[n] += C.B^T for the warp's 16 rows and keys 8n + [0, 8), n < NT, over
// K = kMaxN (columns past N are zero in shared memory). crow points at
// C[row g][t], brow at B[key g][t].
template <int NT>
__device__ __forceinline__ void cb_product(float (&cb)[4][4],
                                           const float* crow,
                                           const float* brow) {
#pragma unroll 4
  for (int k = 0; k < kMaxN; k += 8) {
    uint32_t ab[4], as[4];
    split(crow[k], ab[0], as[0]);
    split(crow[k + 8 * kLdC], ab[1], as[1]);
    split(crow[k + 4], ab[2], as[2]);
    split(crow[k + 8 * kLdC + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = brow + 8 * n * kLdC + k;
      uint32_t bb[2], bsm[2];
      split(b[0], bb[0], bsm[0]);
      split(b[4], bb[1], bsm[1]);
      mma3(cb[n], ab, as, bb, bsm);
    }
  }
}

// Store a thread's C fragments of a 16 x 64 tile: rows r0 + g (+ 8) of
// `out` (leading dim ld), columns 8n + 2t (+ 1); rows >= nr and columns
// >= nc are not stored. Pairs go as one 8-byte store where `pairs`.
__device__ __forceinline__ void store_tile(float* out, size_t ld,
                                           const float (&acc)[8][4], int g,
                                           int t4, int nr, int nc,
                                           bool pairs) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= nr) continue;
    float* row = out + (size_t)r * ld;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t4;
      const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
      if (pairs && c + 1 < nc) {
        *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
      } else {
        if (c < nc) row[c] = v0;
        if (c + 1 < nc) row[c + 1] = v1;
      }
    }
  }
}

// Runs body(t, buf) over nt key tiles through a ring of S shared buffers:
// load(t, buf) issues tile t's cp.async copies into buffer buf, and tiles
// t .. t + S - 1 are in flight while tile t is computed. Copies issued
// before the call join tile 0's group. Ends with a barrier, so the
// buffers may be reused at once.
template <int S, typename Load, typename Body>
__device__ __forceinline__ void tile_loop(int nt, Load&& load, Body&& body) {
  if constexpr (S == 1) {
    for (int t = 0; t < nt; ++t) {
      if (t > 0) __syncthreads();
      load(t, 0);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      body(t, 0);
    }
  } else {
    for (int i = 0; i < S - 1; ++i) {
      if (i < nt) load(i, i);
      cp_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_wait<S - 2>();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
      if (t + S - 1 < nt) load(t + S - 1, (t + S - 1) % S);
      cp_commit();
      body(t, t % S);
    }
  }
  __syncthreads();
}

template <int G>
__device__ __forceinline__ void y_block(
    const float* __restrict__ xz, const float* __restrict__ caz,
    const float* __restrict__ bz, const float* __restrict__ cz,
    float* __restrict__ yz, int Q, int H, int P, int N, int WR, int rb,
    int hg, bool vec, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int HB = (4 / WR) * G, R = 16 * WR;
  const int r0 = rb * R, h0 = hg * HB;
  const int nh = min(HB, H - h0), rows = min(R, Q - r0);
  const int jend = r0 + rows;                 // keys the block's rows see
  const int nt = (jend + kKT - 1) / kKT, Qc = nt * kKT;
  const int stages = min(nt, kYStages);
  float* Cs = smem;                           // R x kLdC
  float* cas = Cs + R * kLdC;                 // HB x Qc
  float* Bs = cas + HB * Qc;                  // stages x kKT x kLdC
  float* Xs = Bs + stages * kKT * kLdC;       // stages x HB x kKT x kLdXY

  stage(Cs, kLdC, cz + (size_t)r0 * N, N, R, kMaxN, rows, N, vec, tid);
  for (int e = tid; e < HB * Qc; e += kThreads) {
    const int hl = e / Qc, j = e % Qc;
    const bool ok = hl < nh && j < jend;
    cp4(cas + e, ok ? caz + (size_t)j * H + h0 + hl : caz, ok);
  }
  auto load = [&](int t, int buf) {
    const int j0 = t * kKT, nk = min(kKT, jend - j0);
    float* bs = Bs + buf * kKT * kLdC;
    float* xs = Xs + buf * HB * kKT * kLdXY;
    stage(bs, kLdC, bz + (size_t)j0 * N, N, kKT, kMaxN, nk, N, vec, tid);
    for (int hl = 0; hl < HB; ++hl)
      stage(xs + hl * kKT * kLdXY, kLdXY,
            xz + ((size_t)j0 * H + min(h0 + hl, H - 1)) * P, (size_t)H * P,
            kKT, kMaxP, hl < nh ? nk : 0, P, vec, tid);
  };
  const int wr = warp % WR, wh = warp / WR;
  const int i0 = r0 + 16 * wr;                // the warp's first row
  const int ia = i0 + g, ib = ia + 8;         // rows of c0/c1 and c2/c3
  const int jlast = min(i0 + 15, Q - 1);      // the warp's last key
  const bool live = i0 < Q;
  float acc[G][8][4];
#pragma unroll
  for (int gg = 0; gg < G; ++gg)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gg][p][e] = 0.f;

  tile_loop<kYStages>(nt, load, [&](int t, int buf) {
    const int j0 = t * kKT;
    if (live && j0 <= jlast) {
      const float* bs = Bs + buf * kKT * kLdC;
      const float* xs = Xs + buf * HB * kKT * kLdXY;
      // C.B^T of the warp's 16 rows and the tile's keys (the first 16 only
      // where the rest lie above the diagonal), K = N
      float cb[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
      const float* crow = Cs + (16 * wr + g) * kLdC + t4;
      const float* brow = bs + g * kLdC + t4;
      if (j0 + 16 <= jlast)
        cb_product<4>(cb, crow, brow);
      else
        cb_product<2>(cb, crow, brow);
      // per head: W = CB o exp(ca_i - ca_j) on j <= i < Q, then y += W X
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const int hl = wh * G + gg;
        if (hl >= nh) continue;
        const float* ca = cas + hl * Qc;
        const float cai = ia < Q ? ca[ia] : 0.f;
        const float cbi = ib < Q ? ca[ib] : 0.f;
        const float* xh = xs + hl * kKT * kLdXY + 2 * t4 * kLdXY + g;
#pragma unroll
        for (int n = 0; n < 4; ++n) {           // keys j0 + 8n + (2t, 2t+1)
          if (j0 + 8 * n > jlast) continue;     // above the diagonal
          const int j = j0 + 8 * n + 2 * t4;
          const float ca0 = ca[j], ca1 = ca[j + 1];
          const float w0 = (ia < Q && j <= ia) ? cb[n][0] * __expf(cai - ca0) : 0.f;
          const float w1 = (ia < Q && j + 1 <= ia) ? cb[n][1] * __expf(cai - ca1) : 0.f;
          const float w2 = (ib < Q && j <= ib) ? cb[n][2] * __expf(cbi - ca0) : 0.f;
          const float w3 = (ib < Q && j + 1 <= ib) ? cb[n][3] * __expf(cbi - ca1) : 0.f;
          uint32_t ab[4], as[4];
          split(w0, ab[0], as[0]);
          split(w2, ab[1], as[1]);
          split(w1, ab[2], as[2]);
          split(w3, ab[3], as[3]);
          const float* x = xh + 8 * n * kLdXY;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            uint32_t bb[2], bsm[2];
            split(x[8 * p], bb[0], bsm[0]);
            split(x[kLdXY + 8 * p], bb[1], bsm[1]);
            mma3(acc[gg][p], ab, as, bb, bsm);
          }
        }
      }
    }
  });
  if (!live) return;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const int hl = wh * G + gg;
    if (hl < nh)
      store_tile(yz + ((size_t)ia * H + h0 + hl) * P, (size_t)H * P,
                 acc[gg], 0, t4, Q - ia, P, vec);
  }
}

__device__ __forceinline__ void s_block(
    const float* __restrict__ xz, const float* __restrict__ caz,
    const float* __restrict__ bz, float* __restrict__ sz, int Q, int H,
    int P, int N, int h, int n0, bool vec, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt = (Q + kKT - 1) / kKT;
  const int ncol = min(kNW, N - n0);
  float* cas = smem;                          // nt * kKT
  float* Ss = cas + nt * kKT;                 // stages x (X, B) tiles

  for (int j = tid; j < nt * kKT; j += kThreads)
    cp4(cas + j, j < Q ? caz + (size_t)j * H + h : caz, j < Q);
  auto load = [&](int t, int buf) {
    const int j0 = t * kKT, nk = min(kKT, Q - j0);
    float* xs = Ss + buf * 2 * kKT * kLdS;
    stage(xs, kLdS, xz + ((size_t)j0 * H + h) * P, (size_t)H * P, kKT,
          kMaxP, nk, P, vec, tid);
    stage(xs + kKT * kLdS, kLdS, bz + (size_t)j0 * N + n0, N, kKT, kNW, nk,
          ncol, vec, tid);
  };
  const int p0 = 16 * warp;
  const bool live = p0 < P;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  tile_loop<kSStages>(nt, load, [&](int t, int buf) {
    if (!live) return;
    const float ca_end = cas[Q - 1];
    const float* xs = Ss + buf * 2 * kKT * kLdS;
    const float* bs = xs + kKT * kLdS;
    const int ksteps = min(kKT, Q - t * kKT);  // keys past Q are padding
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 8) {
      if (kk >= ksteps) break;
      const int j = t * kKT + kk + t4;
      const float d0 = j < Q ? __expf(ca_end - cas[j]) : 0.f;
      const float d1 = j + 4 < Q ? __expf(ca_end - cas[j + 4]) : 0.f;
      const float* x = xs + (kk + t4) * kLdS + p0 + g;  // A = (X o d)^T
      uint32_t ab[4], as[4];
      split(x[0] * d0, ab[0], as[0]);
      split(x[8] * d0, ab[1], as[1]);
      split(x[4 * kLdS] * d1, ab[2], as[2]);
      split(x[4 * kLdS + 8] * d1, ab[3], as[3]);
      const float* b = bs + (kk + t4) * kLdS + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bb[2], bsm[2];
        split(b[8 * n], bb[0], bsm[0]);
        split(b[4 * kLdS + 8 * n], bb[1], bsm[1]);
        mma3(acc[n], ab, as, bb, bsm);
      }
    }
  });
  if (!live) return;
  store_tile(sz + ((size_t)h * P + p0) * N + n0, N, acc, g, t4, P - p0,
             ncol, vec);
}

// Grid (n_y + H * ceil(N / 64), Z). xdt/y: (Z, Q, H, P); cum_a: (Z, Q, H);
// Br/Cr: (Z, Q, N); s: (Z, H, P, N).
template <int G>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ cum_a,
           const float* __restrict__ Br, const float* __restrict__ Cr,
           float* __restrict__ y, float* __restrict__ s, int Q, int H, int P,
           int N, int WR, int n_y, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.y, bx = blockIdx.x;
  const float* xz = xdt + (size_t)z * Q * H * P;
  const float* caz = cum_a + (size_t)z * Q * H;
  const float* bz = Br + (size_t)z * Q * N;
  if (bx < n_y) {
    // the row blocks with the most keys first
    const int HG = (H + (4 / WR) * G - 1) / ((4 / WR) * G);
    const int RB = (Q + 16 * WR - 1) / (16 * WR);
    y_block<G>(xz, caz, bz, Cr + (size_t)z * Q * N,
               y + (size_t)z * Q * H * P, Q, H, P, N, WR,
               RB - 1 - bx / HG, bx % HG, vec != 0, smem);
  } else {
    const int NS = (N + kNW - 1) / kNW, e = bx - n_y;
    s_block(xz, caz, bz, s + (size_t)z * H * P * N, Q, H, P, N, e / NS,
            (e % NS) * kNW, vec != 0, smem);
  }
}

template <int G>
int launch(const float* xdt, const float* cum_a, const float* Br,
           const float* Cr, float* y, float* s, int Z, int Q, int H, int P,
           int N, int WR, bool vec, cudaStream_t st) {
  const int HB = (4 / WR) * G, R = 16 * WR;
  const int n_y = (Q + R - 1) / R * ((H + HB - 1) / HB);
  const int n_s = H * ((N + kNW - 1) / kNW);
  const int ys = y_smem_floats(WR, HB, Q), ss = s_smem_floats(Q);
  const int smem = (int)sizeof(float) * (ys > ss ? ys : ss);
  // the opt-in above 48 KB, set once per instantiation and size reached
  static int opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  ssd_kernel<G><<<dim3(n_y + n_s, Z), kThreads, smem, st>>>(
      xdt, cum_a, Br, Cr, y, s, Q, H, P, N, WR, n_y, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// xdt (Z, Q, H, P), cum_a (Z, Q, H), Br/Cr (Z, Q, N), all fp32, Z = B * nc;
// outputs y (Z, Q, H, P), s (Z, H, P, N). One launch; returns
// cudaGetLastError() after it.
extern "C" int ssd_intra(const void* xdt, const void* cum_a, const void* Br,
                         const void* Cr, void* y, void* s, int Z, int Q,
                         int H, int P, int N, void* stream) {
  if (Z <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int WR = Q <= 16 ? 1 : Q <= 32 ? 2 : 4;
  const bool vec = P % 4 == 0 && N % 4 == 0 &&
      ((uintptr_t)xdt | (uintptr_t)Br | (uintptr_t)Cr | (uintptr_t)y |
       (uintptr_t)s) % 16 == 0;
  const auto* x = (const float*)xdt;
  const auto* ca = (const float*)cum_a;
  const auto* b = (const float*)Br;
  const auto* c = (const float*)Cr;
  cudaStream_t st = (cudaStream_t)stream;
  return Q > 64
      ? launch<2>(x, ca, b, c, (float*)y, (float*)s, Z, Q, H, P, N, WR, vec, st)
      : launch<1>(x, ca, b, c, (float*)y, (float*)s, Z, Q, H, P, N, WR, vec, st);
}
