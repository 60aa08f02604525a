// Causal / non-causal flash attention for Hopper (sm_90a): the prefill
// (chunk of T > 1 queries) attention of the serving path, over a
// contiguous cache row (`flash_attention`) or through the paged pools and
// a block table (`paged_flash_attention`, bf16).
//
// Replaces the Pallas kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention.py.
//
// Bound: at the chunk lengths of chunked prefill against a 1k-slot cache
// the work is small (16 queries x G heads per kv head) and bound by the
// K/V bytes of the visible keys and by latency; at long chunks it nears
// the card's operations-per-byte line, so the products belong on the
// tensor cores.
//
// Which dtype takes which path:
// * bf16 (the serving dtype): the tensor-core kernel of attention_mma.cuh.
//   A block packs the G query heads of one kv head as rows, token-major
//   (row (t, g) is q[b, t, kvh*G + g]), so a 16-token chunk of granite
//   fills 64 rows and K/V are read once for all G heads; S and P V are
//   mma.sync.m16n8k16 products from bf16 tiles loaded with cp.async one
//   ahead of the one in use; a tile no row can see is skipped after
//   reading its k_pos; the key axis is split across blocks when the grid
//   is under half a wave, with the combine pass and split count
//   (`kernels/split.py`) shared with the decode kernels. A paged chunk
//   runs the same kernel through the block table: each key row of a tile
//   is loaded from its own physical slot of the pools, so nothing is
//   gathered first.
// * fp32: `flash_kernel` below, on CUDA cores in fp32 (mma.sync in TF32
//   would not hold the fp32 model tests' 1e-4). Grid (ceil(Tq/64), H, B):
//   one block owns 64 query rows of one head and loops over K/V tiles of
//   64 keys staged in shared memory. Each of the 4 warps owns 16 query
//   rows; a lane owns keys (lane, lane+32) of a tile for the scores and
//   head dims (lane + 32c) of the output, so the row max and sum of the
//   online softmax are warp reductions held in registers. Each thread
//   issues all of its 16-byte loads of a tile before it converts and
//   stores any, so a tile's loads are in flight together.
//
// Both paths: masks are the JAX package's: kpos >= 0, causal kpos <= qpos,
// window kpos > qpos - window. Masked scores take -1e30 and probability
// exactly 0; the denominator is clamped at 1e-30. Ragged Tq and Tk tails
// are masked, never padded. A K/V tile in which no key is visible to any
// row of the block (empty cache slots, keys past the causal edge) is
// skipped whole.
#include "attention_mma.cuh"

namespace {

using repro::kNegInf;
using repro::store;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kRows = kBQ / (kThreads / 32);  // query rows per warp

__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window == 0 || kp > qp - window);
}

// 214,024 bytes at HD 256, inside the 232,448 a block may opt in to.
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * kBK) +
         sizeof(int) * (kBQ + kBK + 2);
}

// q/out: (B, Tq, H, HD); k/v: (B, Tk, KV, HD); q_pos: (B, Tq); k_pos: (B, Tk).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, T* __restrict__ out, int Tq,
             int Tk, int H, int KV, int window, int causal) {
  constexpr int HD = 32 * NC, ld = HD + 1;
  const int t0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRows;
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x ld
  float* Ks = Qs + kBQ * ld;        // kBK x ld
  float* Vs = Ks + kBK * ld;        // kBK x HD
  float* Ps = Vs + kBK * HD;        // kBQ x kBK probabilities (per-warp rows)
  int* qpos_s = reinterpret_cast<int*>(Ps + kBQ * kBK);
  int* kpos_s = qpos_s + kBQ;
  int* qrange = kpos_s + kBK;       // [max, min] query position of the block

  if (tid == 0) { qrange[0] = -1; qrange[1] = 0x7fffffff; }
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  repro::load_tiles<T, HD, kBQ, kThreads>(
      q + ((size_t)b * Tq + t0) * q_stride + (size_t)h * HD, nullptr,
      q_stride, min(kBQ, Tq - t0), Qs, ld, nullptr, 0, tid);
  __syncthreads();
  if (tid < kBQ) {
    const int t = t0 + tid;
    const int qp = t < Tq ? q_pos[(size_t)b * Tq + t] : -1;
    qpos_s[tid] = qp;
    if (t < Tq) { atomicMax(&qrange[0], qp); atomicMin(&qrange[1], qp); }
  }
  __syncthreads();
  const int qmax = qrange[0], qmin = qrange[1];
  const float rs = sqrtf((float)HD);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int s0 = 0; s0 < Tk; s0 += kBK) {
    int kp = -1;
    if (tid < kBK && s0 + tid < Tk) kp = k_pos[(size_t)b * Tk + s0 + tid];
    __syncthreads();  // the previous tile's shared reads are done
    if (tid < kBK) kpos_s[tid] = kp;
    // a conservative test for the whole block: skip a tile no row can see
    const int any = tid < kBK && kp >= 0 && (!causal || kp <= qmax) &&
                    (window == 0 || kp > qmin - window);
    if (!__syncthreads_or(any)) continue;
    const size_t kv0 = ((size_t)b * Tk + s0) * kv_stride + (size_t)kvh * HD;
    repro::load_tiles<T, HD, kBK, kThreads>(k + kv0, v + kv0, kv_stride,
                                            min(kBK, Tk - s0), Ks, ld, Vs, HD,
                                            tid);
    __syncthreads();

    float sc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float k0 = Ks[lane * ld + d], k1 = Ks[(lane + 32) * ld + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qs[(r0 + r) * ld + d];
        sc[r][0] = fmaf(qv, k0, sc[r][0]);
        sc[r][1] = fmaf(qv, k1, sc[r][1]);
      }
    }
    const int kp0 = kpos_s[lane], kp1 = kpos_s[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = qpos_s[r0 + r];
      const bool v0 = visible(kp0, qp, causal, window);
      const bool v1 = visible(kp1, qp, causal, window);
      const float a0 = v0 ? sc[r][0] / rs : kNegInf;
      const float a1 = v1 ? sc[r][1] / rs : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a0, a1)));
      const float p0 = v0 ? expf(a0 - m_new) : 0.f;
      const float p1 = v1 ? expf(a1 - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      Ps[(r0 + r) * kBK + lane] = p0;
      Ps[(r0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only its own probability rows
    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = Ps[(r0 + r) * kBK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r0 + r;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + ((size_t)b * Tq + t) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + lane + 32 * c, acc[r][c] * inv);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, int B, int Tq, int Tk, int H, int KV,
           int window, int causal, void* stream) {
  auto kern = flash_kernel<T, NC>;
  constexpr size_t smem = smem_bytes<32 * NC>();
  static_assert(smem <= 232448, "shared memory over the per-block opt-in");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)q_pos,
      (const int*)k_pos, (T*)out, Tq, Tk, H, KV, window, causal);
  return (int)cudaGetLastError();
}

int dispatch_fp32(int hd, const void* q, const void* k, const void* v,
                  const void* q_pos, const void* k_pos, void* out, int B,
                  int Tq, int Tk, int H, int KV, int window, int causal,
                  void* stream) {
  switch (hd) {
    case 32: return launch<float, 1>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, H, KV, window, causal, stream);
    case 64: return launch<float, 2>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, H, KV, window, causal, stream);
    case 128: return launch<float, 4>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, H, KV, window, causal, stream);
    case 256: return launch<float, 8>(q, k, v, q_pos, k_pos, out, B, Tq, Tk, H, KV, window, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64, 128, 256}. Returns
// cudaGetLastError() after the last launch. bf16 goes to the tensor-core
// kernel, with n_splits key ranges and, when n_splits > 1, the scratch
// part_o (n_splits, B*Tq*H, hd) fp32 and part_ml (n_splits, B*Tq*H, 2)
// fp32 for the combine pass; fp32 goes to `flash_kernel` and ignores the
// three.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* q_pos,
                               const void* k_pos, void* out, void* part_o,
                               void* part_ml, int B, int Tq, int Tk, int H,
                               int KV, int hd, int window, int causal,
                               int n_splits, void* stream) {
  if (KV <= 0 || H % KV || Tq <= 0 || Tk <= 0 || hd < 32)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return repro::mma_attention(hd, q, k, v, q_pos, k_pos, nullptr, 0, out,
                                part_o, part_ml, B, Tq, Tk, H, KV, window,
                                causal, n_splits, stream);
  if (dtype == 0)
    return dispatch_fp32(hd, q, k, v, q_pos, k_pos, out, B, Tq, Tk, H, KV,
                         window, causal, stream);
  return (int)cudaErrorInvalidValue;
}

// bf16 only: q/out (B, Tq, H, hd); k/v_pool (NB, block_size, KV, hd);
// kpos_pool (NB, block_size); tables (B, MB), -1 = unallocated; the logical
// row is MB * block_size slots. Scratch and n_splits as `flash_attention`.
// (fp32 inputs gather the paged view in the wrapper and take
// `flash_attention`.)
extern "C" int paged_flash_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* q_pos,
                                     const void* kpos_pool, const void* tables,
                                     void* out, void* part_o, void* part_ml,
                                     int B, int Tq, int H, int KV, int hd,
                                     int block_size, int MB, int window,
                                     int causal, int n_splits, void* stream) {
  if (KV <= 0 || H % KV || Tq <= 0 || MB <= 0 || hd < 32)
    return (int)cudaErrorInvalidValue;
  return repro::mma_attention(hd, q, k_pool, v_pool, q_pos, kpos_pool, tables,
                              block_size, out, part_o, part_ml, B, Tq,
                              MB * block_size, H, KV, window, causal,
                              n_splits, stream);
}
