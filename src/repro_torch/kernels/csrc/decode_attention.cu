// GQA flash decode for Hopper (sm_90a): one new query token per request
// against its KV cache, in the contiguous and the paged cache layout.
//
// Replaces the Pallas kernels `decode_attention_kernel` (contiguous) and
// `paged_decode_attention_kernel` (paged) of
// src/repro/kernels/decode_attention.py.
//
// Bound: device-memory bytes. Each request's K and V rows are read once;
// the arithmetic is 4*hd operations per (query head, key), far below the
// card's operations-per-byte line, so the kernels have to keep enough loads
// in flight and read nothing twice.
//
// Which dtype takes which path:
// * bf16 (the serving dtype), contiguous and paged: the tensor-core kernel
//   of attention_mma.cuh as the Tq = 1 case. A block packs the G query
//   heads of one kv head as rows (padded to 16 with zero rows; the block's
//   4 warps split each key tile), reads the row's K/V once in bf16 tiles
//   loaded with cp.async two ahead of the one in use, skips a tile whose
//   slots are all invisible after reading only its k_pos, and splits the
//   key axis across blocks (flash-decoding) when the (B, KV) grid is under
//   half a wave; the combine pass and the split count (`kernels/split.py`)
//   are shared with the prefill kernel. Paged, the same kernel walks the
//   block table: each key row of a 64-key tile is loaded from its own
//   physical slot (a tile spans 64 / bs blocks), and a slot whose table
//   entry is < 0 reads as empty and is never read.
// * fp32 (the on-card model tests), contiguous and paged: `decode_kernel`
//   below, one block per (B, KV) on CUDA cores in fp32 (mma.sync in TF32
//   would not hold the fp32 model tests' 1e-4). It loops over KV tiles
//   staged in shared memory as fp32: 64 contiguous slots with the ragged
//   tail masked, or one paged block of `block_size` <= 64 slots found
//   through tables[b, s]; a table entry < 0 contributes nothing and its
//   physical block is never read. Each thread issues all of its 16-byte
//   loads of a tile before it converts and stores any, so a tile's loads
//   are in flight together.
//
// Both paths: masked keys take the score -1e30 and the probability exactly
// 0, and the denominator is clamped at 1e-30, so a row with no visible key
// (a padding row of a decode bucket) returns 0. On every row with a
// visible key this is the JAX package's semantics in exact arithmetic.
#include "attention_mma.cuh"

namespace {

using repro::kNegInf;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 128;
constexpr int kTile = 64;       // slots per KV tile (paged: block_size <= kTile)
// accumulators per thread: G*hd <= 2048, and 4096 at hd 256 (16 query heads
// on one kv head), so the narrower heads keep their register budget
__host__ __device__ constexpr int max_acc(int hd) { return hd >= 256 ? 32 : 16; }

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)kTile * (hd + 1) + (size_t)kTile * hd +
                          (size_t)G * hd + (size_t)G * kTile + 3 * (size_t)G) +
         sizeof(int) * kTile;
}

// Contiguous: k/v are (B, S, KV, HD), k_pos is (B, S), `span` = S.
// Paged: k/v are (NB, bs, KV, HD), k_pos is (NB, bs), tables is
// (B, n_tiles), `span` = bs. q and out are (B, H, HD); q_pos is (B,).
template <bool PAGED, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ k_pos, const int* __restrict__ tables,
              float* __restrict__ out, int H, int KV, int span, int n_tiles,
              int window) {
  constexpr int ld = HD + 1;  // padded key rows: conflict-free column reads
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / KV, GD = G * HD;
  extern __shared__ float smem[];
  float* Ks = smem;                 // kTile x ld
  float* Vs = Ks + kTile * ld;      // kTile x HD
  float* Qs = Vs + kTile * HD;      // G x HD
  float* Ps = Qs + GD;              // G x kTile: scores, then probabilities
  float* Ms = Ps + G * kTile;       // running max
  float* Ls = Ms + G;               // running denominator
  float* As = Ls + G;               // this tile's rescale factor
  int* valid = reinterpret_cast<int*>(As + G);

  const int qp = q_pos[b];
  float* o = out + ((size_t)b * H + (size_t)kvh * G) * HD;
  if (qp < 0) {  // padding row: no key can be visible
    for (int i = tid; i < GD; i += kThreads) o[i] = 0.f;
    return;
  }
  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int i = tid; i < GD; i += kThreads) Qs[i] = qb[i];
  for (int g = tid; g < G; g += kThreads) { Ms[g] = kNegInf; Ls[g] = 0.f; }
  constexpr int kMaxAcc = max_acc(HD);
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;
  const float rs = sqrtf((float)HD);
  const size_t tok_stride = (size_t)KV * HD;

  for (int t = 0; t < n_tiles; ++t) {
    int n;
    size_t tok0;  // first slot of the tile in k's flattened token axis
    if (PAGED) {
      const int blk = tables[(size_t)b * n_tiles + t];
      if (blk < 0) continue;  // unallocated: uniform over the block
      n = span;
      tok0 = (size_t)blk * span;
    } else {
      n = min(kTile, span - t * kTile);
      tok0 = (size_t)b * span + (size_t)t * kTile;
    }
    __syncthreads();  // the previous tile's shared reads are done
    repro::load_tiles<float, HD, kTile, kThreads>(
        k + tok0 * tok_stride + (size_t)kvh * HD,
        v + tok0 * tok_stride + (size_t)kvh * HD, tok_stride, n, Ks, ld, Vs,
        HD, tid);
    for (int j = tid; j < kTile; j += kThreads) {
      int ok = 0;
      if (j < n) {
        const int kp = k_pos[tok0 + j];
        ok = kp >= 0 && kp <= qp && (window == 0 || kp > qp - window);
      }
      valid[j] = ok;
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i - g * kTile;
      float s = kNegInf;
      if (valid[j]) {
        const float* qr = Qs + g * HD;
        const float* kr = Ks + j * ld;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot / rs;
      }
      Ps[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {  // online softmax, warp per head
      float* pr = Ps + g * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = valid[lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = valid[lane + 32] ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + psum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int i = tid + r * kThreads;
      if (i < GD) {
        const int g = i / HD, d = i - g * HD;
        const float* pr = Ps + g * kTile;
        float a = acc[r] * As[g];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], Vs[j * HD + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int i = tid + r * kThreads;
    if (i < GD) o[i] = acc[r] / fmaxf(Ls[i / HD], 1e-30f);
  }
}

template <bool PAGED, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, const void* tables, void* out, int B, int H,
           int KV, int span, int n_tiles, int window, void* stream) {
  auto kern = decode_kernel<PAGED, HD>;
  const size_t smem = smem_bytes(H / KV, HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, KV), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)q_pos,
      (const int*)k_pos, (const int*)tables, (float*)out, H, KV, span,
      n_tiles, window);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* q_pos, const void* k_pos, const void* tables,
             void* out, int B, int H, int KV, int span, int n_tiles,
             int window, void* stream) {
  if (KV <= 0 || H % KV || (H / KV) * hd > max_acc(hd) * kThreads ||
      span <= 0 || (PAGED && span > kTile))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
#define REPRO_DECODE_CASE(HD_)                                              \
  case HD_:                                                                 \
    return launch<PAGED, HD_>(q, k, v, q_pos, k_pos, tables, out, B, H, KV, \
                              span, n_tiles, window, stream);
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
#undef REPRO_DECODE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128, 256}. Every entry
// returns cudaGetLastError() after its last launch.
//
// bf16 goes to the tensor-core kernel, with n_splits key ranges and, when
// n_splits > 1, the scratch part_o (n_splits, B*H, hd) fp32 and part_ml
// (n_splits, B*H, 2) fp32 for the combine pass; fp32 goes to
// `decode_kernel` and ignores the three.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* q_pos,
                                const void* k_pos, void* out, void* part_o,
                                void* part_ml, int B, int H, int KV, int hd,
                                int S, int window, int n_splits,
                                void* stream) {
  if (dtype == 1)
    return repro::mma_attention(hd, q, k, v, q_pos, k_pos, nullptr, 0, out,
                                part_o, part_ml, B, 1, S, H, KV, window, 1,
                                n_splits, stream);
  if (dtype == 0)
    return dispatch<false>(hd, q, k, v, q_pos, k_pos, nullptr, out, B,
                                  H, KV, S, (S + kTile - 1) / kTile, window,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

// Paged: k/v_pool (NB, block_size, KV, hd), kpos_pool (NB, block_size),
// tables (B, MB); the logical row is MB * block_size slots.
extern "C" int paged_decode_attention(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* q_pos, const void* kpos_pool,
                                      const void* tables, void* out,
                                      void* part_o, void* part_ml, int B,
                                      int H, int KV, int hd, int block_size,
                                      int MB, int window, int n_splits,
                                      void* stream) {
  if (dtype == 1)
    return repro::mma_attention(hd, q, k_pool, v_pool, q_pos, kpos_pool,
                                tables, block_size, out, part_o, part_ml, B,
                                1, MB * block_size, H, KV, window, 1,
                                n_splits, stream);
  if (dtype == 0)
    return dispatch<true>(hd, q, k_pool, v_pool, q_pos, kpos_pool,
                                 tables, out, B, H, KV, block_size, MB, window,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
