// Tensor-core attention for bf16 inputs on Hopper (sm_90a), shared by the
// flash-decode kernels (decode_attention.cu: Tq = 1, contiguous and paged)
// and the prefill flash-attention kernels (flash_attention.cu: chunks over
// a contiguous row or through the block table), with the combine pass of
// the key-axis split that all of them use.
//
// Bound: decode by the bytes of K and V (4*hd operations per query head and
// key, far below the card's operations-per-byte line); a 16-token serving
// chunk by latency and the visible keys' K/V bytes; only long chunks come
// near the line, where the products have to be on the tensor cores.
//
// Rows. A block of 4 warps owns one (batch row, kv head) and up to 64 of
// its M = Tq*G rows. Row r is (token r / G, head-in-group r % G), token-
// major, so the G query heads that read one kv head share every K/V tile
// the block loads; each row takes the masks of its own token. When M > 16
// (prefill chunks) each warp owns 16 rows and all keys of a tile. When the
// rows fit one warp (decode: G = 4 for granite, 16 for recurrentgemma) the
// 4 warps share those 16 rows and each takes a quarter of every 64-key
// tile; at the end they merge their (m, l, O) in shared memory. Rows past
// M (decode at G = 4: 12 of 16) are zero rows that are never stored.
//
// Products. S = Q K^T and O += P V by mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), operands from shared memory by ldmatrix (.trans for V).
// The online softmax runs on the accumulator fragments in registers, in
// base 2 (a thread holds two rows; row max and sum are quad shuffles), and
// P goes back to bf16 as the A operand of P V. Q fragments are read from
// shared memory at every tile rather than held in registers, so the 128
// fp32 accumulators of O at head_dim 256 fit without spills.
//
// Tiles. K/V tiles of BN keys (64; 32 at head_dim 256 when a warp takes a
// whole tile) stay bf16 in shared memory, in a ring of 3 when the warps
// split keys (decode) and of 2 when they split rows (prefill, so that two
// blocks fit an SM): the next visible tiles' cp.async loads are in flight
// while this one's products run. Rows are swizzled (16-byte chunk c of row
// r sits at c ^ (r & 7)) so that ldmatrix and cp.async touch distinct
// banks. The k_pos of up to 1024 slots (4 bytes a slot) are staged first,
// all loads in flight at once, and a tile that no row of the block can see
// (empty slots of a half-filled row, keys past the causal edge or behind
// the window) is skipped: its K/V are never read.
//
// Split. The key tiles are cut into n_splits contiguous ranges, split s
// taking tiles [s*n/ns, (s+1)*n/ns) (`kernels/split.py` picks ns and
// mirrors this formula). With one split the kernel writes the normalized
// output in bf16. Otherwise each split writes its unnormalized fp32 O and
// its (m, l) to scratch, and the combine kernel weights split i by
// exp2(m_i - max_i m_i) and divides by the weighted sum of l. A row that no
// split saw a key of (m = -1e30 and l = 0 everywhere) comes out exactly 0.
//
// Partial (decode_attention_partial, one data rank's slots of a sequence-
// sharded decode). The splits always write their fp32 partials, even one
// split, and the same combine kernel, told not to normalize, folds them
// into one unnormalized (O, m, l) a row, m in natural-log units (the
// scores' max), for the ranks' combine (which runs it once more).
//
// Paged (PAGED = true). k/v are the pools (NB, bs, KV, HD), k_pos the
// pool-wide (NB, bs) position map, and tables (B, MB) the block tables;
// Tk = MB * bs logical slots, and logical slot s of row b is physical slot
// tables[b, s / bs] * bs + s % bs. The walk changes only where addresses
// are formed: when a chunk's k_pos are staged, each slot's physical index
// (-1 where the table entry is < 0) is staged beside it in shared memory,
// its k_pos is read through it (-1 for an unallocated slot), and the tile
// loads read each 16-byte chunk row from its own physical slot, zero-
// filled where the index is -1 (nothing is read). So any bs works, a
// 64-key tile spans 64 / bs blocks, and the tile flags, the skip, the
// ring and the split are the contiguous kernel's.
//
// Semantics (the port's, ROADMAP Queue B): masked scores -1e30 and
// probability exactly 0, denominator clamped at 1e-30, absolute positions
// with -1 for an empty slot, query head h reads kv head h // G, visibility
// kpos >= 0 & kpos <= qpos (causal) & kpos > qpos - window (window > 0),
// ragged Tq / Tk tails masked (zero-filled in shared memory), never padded
// in device memory.
#pragma once

#include "common.cuh"

namespace repro {
namespace {

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaKposChunk = 1024;  // k_pos slots staged at once
constexpr float kLog2e = 1.4426950408889634f;

// WK = warps that split each key tile (4 when the block's rows fit in one
// warp: decode; else 1, and the 4 warps take 16 rows each).
template <int HD, int WK>
struct MmaTile {
  static constexpr int BN = HD >= 256 && WK == 1 ? 32 : 64;  // keys a tile
  static constexpr int KW = BN / WK;                          // keys a warp
  static constexpr int BM = 16 * (4 / WK);                    // rows a block
  static constexpr int CH = HD / 8;                  // 16-byte chunks a row
  static constexpr int BYTES = BN * HD * 2;          // one K or V tile
  // K/V tiles in flight or in use: 3 when the 4 warps split keys (decode:
  // few blocks, each streaming a long row); 2 when they split rows, so
  // that two blocks fit an SM at head_dim 128
  static constexpr int STAGES = WK == 1 ? 2 : 3;
  // K and V of STAGES tiles (reused by the WK warps' merge), the Q rows,
  // a chunk of k_pos, its per-tile flags, the per-warp query ranges; paged,
  // also the chunk's physical slot indices
  static constexpr size_t SMEM =
      2 * STAGES * (size_t)BYTES + (size_t)BM * HD * 2 +
      sizeof(int) * (kMmaKposChunk + kMmaKposChunk / BN + 4);
  static constexpr size_t SMEM_PAGED = SMEM + sizeof(int) * kMmaKposChunk;
  static_assert(SMEM_PAGED <= 232448,
                "shared memory over the per-block opt-in");
  static_assert(WK == 1 || 2 * STAGES * (size_t)BYTES >=
                               sizeof(float) * (WK * 16 * (HD + 3) + 32),
                "the merge of the key warps fits in the K/V stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// of HD bf16 a row.
template <int HD>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  constexpr int CH = HD / 8, SWZ = (CH < 8 ? CH : 8) - 1;
  return (uint32_t)(row * CH + (chunk ^ (row & SWZ))) * 16u;
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ bool mma_visible(int kp, int qp, int causal,
                                            int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window == 0 || kp > qp - window);
}

// q/out: (B, Tq, H, HD); k/v: (B, Tk, KV, HD); q_pos: (B, Tq); k_pos:
// (B, Tk). Paged: k/v (NB, bs, KV, HD), k_pos (NB, bs), tables (B, Tk /
// bs); else tables and bs are unused. part_o: (n_splits, B*Tq*H, HD) fp32,
// part_ml: (n_splits, B*Tq*H) of (m, l); both unused with one split.
// Grid (n_splits, row tiles, B*KV) of 128 threads. Warp w takes rows
// (w % (4/WK)) * 16 + [0, 16) of the block and keys (w / (4/WK)) * KW +
// [0, KW) of each tile.
template <int HD, int WK, bool PAGED>
__global__ void __launch_bounds__(kMmaThreads, 1)
mma_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos,
                     const int* __restrict__ tables, int bs,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part_o, float2* __restrict__ part_ml,
                     int Tq, int Tk, int H, int KV, int window, int causal,
                     int partial) {
  using T = MmaTile<HD, WK>;
  constexpr int BN = T::BN, KW = T::KW, BM = T::BM, CH = T::CH;
  constexpr int KPT = kMmaKposChunk / kMmaThreads;  // k_pos loads a thread
  constexpr int CT = kMmaKposChunk / BN;            // tiles a chunk
  const int split = blockIdx.x, n_splits = gridDim.x;
  // write the unnormalized fp32 partials (else the normalized bf16 output)
  const bool parts = n_splits > 1 || partial;
  const int b = blockIdx.z / KV, kvh = blockIdx.z % KV;
  const int G = H / KV, M = Tq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const int wr = warp % (4 / WK), wk = warp / (4 / WK);
  const int row0 = blockIdx.y * BM;

  extern __shared__ __align__(128) unsigned char mma_smem[];
  // stage i: K at s_base + 2i * BYTES, V right after it; then Q
  const uint32_t s_base = smem_addr(mma_smem);
  const uint32_t s_q = s_base + 2 * T::STAGES * T::BYTES;
  int* kpos_s = reinterpret_cast<int*>(mma_smem + 2 * T::STAGES * T::BYTES +
                                       BM * HD * 2);
  int* flags = kpos_s + kMmaKposChunk;  // a visible slot in tile i of chunk
  int* qrange = flags + CT;             // [max, min] query position, 2 warps
  int* phys_s = qrange + 4;             // paged: physical slot of each k_pos

  for (int c = tid; c < BM * CH; c += kMmaThreads) {
    const int r = c / CH, ch = c - r * CH, gr = row0 + r;
    const bool ok = gr < M;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int t = gr / G;
      src = q + (((size_t)b * Tq + t) * H + (size_t)kvh * G + (gr - t * G)) *
                    HD + ch * 8;
    }
    cp_async16(s_q + swz<HD>(r, ch), src, ok);
  }
  cp_async_commit();

  const int n_tiles = (Tk + BN - 1) / BN;
  const int t_begin = (int)((long long)split * n_tiles / n_splits);
  const int t_end = (int)((long long)(split + 1) * n_tiles / n_splits);
  // k_pos of the chunk of tiles from c0, every load in flight at once;
  // paged, through the block table (ph: the physical slot, -1 where the
  // table entry is < 0)
  int kp[KPT], ph[KPT];
  auto load_kpos = [&](int c0) {
    const int s_end = min(min(t_end, c0 + CT) * BN, Tk);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int s = c0 * BN + tid + i * kMmaThreads;
      if (PAGED) {
        const int blk = s < s_end ? tables[(size_t)b * (Tk / bs) + s / bs]
                                  : -1;
        ph[i] = blk >= 0 ? blk * bs + s % bs : -1;
        kp[i] = ph[i] >= 0 ? k_pos[ph[i]] : -1;
      } else {
        kp[i] = s < s_end ? k_pos[(size_t)b * Tk + s] : -1;
      }
    }
  };
  load_kpos(t_begin);

  // the block's query range (rows < 64: threads of warps 0 and 1)
  {
    const bool ok = tid < BM && row0 + tid < M;
    const int qp = ok ? q_pos[(size_t)b * Tq + (row0 + tid) / G] : -1;
    int qmx = qp, qmn = ok ? qp : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmx = max(qmx, __shfl_xor_sync(0xffffffffu, qmx, o));
      qmn = min(qmn, __shfl_xor_sync(0xffffffffu, qmn, o));
    }
    if (lane == 0 && warp < 2) {
      qrange[2 * warp] = qmx;
      qrange[2 * warp + 1] = qmn;
    }
  }
  // this thread's two rows of the mma fragments: ra and ra + 8
  const int ra = row0 + wr * 16 + quad, rb = ra + 8;
  const int qpa = ra < M ? q_pos[(size_t)b * Tq + ra / G] : -1;
  const int qpb = rb < M ? q_pos[(size_t)b * Tq + rb / G] : -1;
  const bool warp_live = row0 + wr * 16 < M;

  const size_t kv_stride = (size_t)KV * HD;

  // 16-byte chunks a thread copies of a K (and of a V) tile; paged, their
  // physical slots are read from shared memory ahead of the copies, NP at a
  // time (cp.async's memory clobber would otherwise order each read after
  // the copy before it; 4 at head_dim 256 for the registers)
  constexpr int NI = (BN * CH + kMmaThreads - 1) / kMmaThreads;
  constexpr int NP = NI < (HD >= 256 ? 4 : 8) ? NI : (HD >= 256 ? 4 : 8);
  static_assert(NI % NP == 0, "whole batches of physical slots");
  // tile t of the chunk from c0 into stage st; paged, each key row from
  // its own physical slot
  auto load_tile = [&](int t, int st, int c0) {
    const uint32_t sk = s_base + 2 * st * T::BYTES, sv = sk + T::BYTES;
    if (PAGED) {
#pragma unroll
      for (int i0 = 0; i0 < NI; i0 += NP) {
        int p[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int c = tid + (i0 + j) * kMmaThreads;
          p[j] = BN * CH % kMmaThreads == 0 || c < BN * CH
                     ? phys_s[(t - c0) * BN + c / CH] : -1;
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int c = tid + (i0 + j) * kMmaThreads;
          if (BN * CH % kMmaThreads == 0 || c < BN * CH) {
            const int r = c / CH, ch = c - r * CH;
            const bool ok = p[j] >= 0;
            const size_t off =
                ok ? (size_t)p[j] * kv_stride + (size_t)kvh * HD + ch * 8 : 0;
            cp_async16(sk + swz<HD>(r, ch), k + off, ok);
            cp_async16(sv + swz<HD>(r, ch), v + off, ok);
          }
        }
      }
      return;
    }
    const size_t base =
        ((size_t)b * Tk + (size_t)t * BN) * kv_stride + (size_t)kvh * HD;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = tid + i * kMmaThreads;
      if (BN * CH % kMmaThreads == 0 || c < BN * CH) {
        const int r = c / CH, ch = c - r * CH;
        const bool ok = t * BN + r < Tk;
        const size_t off = ok ? base + (size_t)r * kv_stride + ch * 8 : 0;
        cp_async16(sk + swz<HD>(r, ch), k + off, ok);
        cp_async16(sv + swz<HD>(r, ch), v + off, ok);
      }
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale = kLog2e / sqrtf((float)HD);
  int ld_st = 0, st = 0;  // stage of the next load, of the next compute

  for (int c0 = t_begin; c0 < t_end; c0 += CT) {
    const int c1 = min(t_end, c0 + CT);
    // Stage the chunk's k_pos, then flag the tiles that some row of the
    // block can see.
    if (c0 != t_begin) {
      __syncthreads();  // the previous chunk's readers are done
      load_kpos(c0);
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      kpos_s[tid + i * kMmaThreads] = kp[i];
      if (PAGED) phys_s[tid + i * kMmaThreads] = ph[i];
    }
    if (tid < CT) flags[tid] = 0;
    __syncthreads();
    const int qmax = max(qrange[0], qrange[2]);
    const int qmin = min(qrange[1], qrange[3]);
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (kp[i] >= 0 && (!causal || kp[i] <= qmax) &&
          (window == 0 || kp[i] > qmin - window))
        flags[(tid + i * kMmaThreads) / BN] = 1;
    __syncthreads();

    auto next_visible = [&](int t) {
      while (t < c1 && !flags[t - c0]) ++t;
      return t;
    };
    // T::STAGES - 1 tiles in flight ahead of the one computed; a group
    // is committed for every step, empty past the last visible tile, so
    // that wait_group counts steps
    int t = next_visible(c0), tl = t;
#pragma unroll
    for (int i = 0; i < T::STAGES - 1; ++i) {
      if (tl < c1) {
        load_tile(tl, ld_st, c0);
        ld_st = ld_st + 1 == T::STAGES ? 0 : ld_st + 1;
        tl = next_visible(tl + 1);
      }
      cp_async_commit();
    }
    while (t < c1) {
      if (tl < c1) {
        load_tile(tl, ld_st, c0);
        ld_st = ld_st + 1 == T::STAGES ? 0 : ld_st + 1;
        tl = next_visible(tl + 1);
      }
      cp_async_commit();
      cp_async_wait<T::STAGES - 1>();  // tile t has landed
      __syncthreads();
      if (warp_live) {
        const uint32_t sk = s_base + 2 * st * T::BYTES, sv = sk + T::BYTES;
        const int k0 = wk * KW;  // this warp's first key of the tile
        float s[KW / 8][4];
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // S = Q K^T
          uint32_t a[4];
          ldsm_x4(s_q + swz<HD>(wr * 16 + (lane & 15), 2 * kk + (lane >> 4)),
                  a);
#pragma unroll
          for (int nn = 0; nn < KW / 16; ++nn) {
            uint32_t bk[4];
            ldsm_x4(sk + swz<HD>(k0 + nn * 16 + (lane & 7) +
                                     ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)),
                    bk);
            mma_bf16(s[2 * nn], a, bk[0], bk[1]);
            mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
          }
        }
        // mask, then the online softmax on the fragments: element (n, c)
        // is row (c < 2 ? ra : rb), key k0 + n*8 + 2*tq + (c & 1)
        const int* kp_t = kpos_s + (t - c0) * BN + k0;
        uint32_t vis = 0;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool ok = mma_visible(kp_t[n * 8 + 2 * tq + (c & 1)],
                                        c < 2 ? qpa : qpb, causal, window);
            s[n][c] = ok ? s[n][c] * scale : kNegInf;
            vis |= (uint32_t)ok << (4 * n + c);
            mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
          }
        }
        float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = exp2f(m[h] - mx[h]);
          m[h] = mx[h];
        }
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p =
                (vis >> (4 * n + c)) & 1u ? exp2f(s[n][c] - m[c >> 1]) : 0.f;
            s[n][c] = p;
            rsum[c >> 1] += p;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk) {  // O += P V
          const uint32_t a[4] = {
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int nn = 0; nn < HD / 16; ++nn) {
            uint32_t bv[4];
            ldsm_x4_trans(sv + swz<HD>(k0 + kk * 16 + (lane & 7) +
                                           (((lane >> 3) & 1) << 3),
                                       2 * nn + (lane >> 4)),
                          bv);
            mma_bf16(o[2 * nn], a, bv[0], bv[1]);
            mma_bf16(o[2 * nn + 1], a, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // stage st is free for the next load
      t = next_visible(t + 1);
      st = st + 1 == T::STAGES ? 0 : st + 1;
    }
  }
  cp_async_wait<0>();  // the Q load, when no tile was visible

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t rows = (size_t)(gridDim.z / KV) * Tq * H;
  auto out_row = [&](int r) {  // row r of this (b, kvh) in (B*Tq*H)
    const int tok = r / G;
    return ((size_t)b * Tq + tok) * H + (size_t)kvh * G + (r - tok * G);
  };

  if (WK == 1) {
    if (!warp_live) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      if (r >= M) continue;
      const size_t orow = out_row(r);
      if (!parts) {
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        __nv_bfloat16* dst = out + orow * HD + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
              __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      } else {
        float* dst = part_o + ((size_t)split * rows + orow) * HD + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[n][2 * h], o[n][2 * h + 1]);
        if (tq == 0)
          part_ml[(size_t)split * rows + orow] = make_float2(m[h], l[h]);
      }
    }
    return;
  }

  // WK > 1: the key warps share the block's 16 rows; merge their (m, l, O)
  // in shared memory (the K/V stages, free now), then write as above.
  __syncthreads();
  float* mo = reinterpret_cast<float*>(mma_smem);  // [WK][16][HD]
  float2* mls = reinterpret_cast<float2*>(mo + WK * 16 * HD);  // [WK][16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = quad + 8 * h;
    float* dst = mo + ((size_t)wk * 16 + r) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (tq == 0) mls[wk * 16 + r] = make_float2(m[h], l[h]);
  }
  __syncthreads();
  // per row: the max m over the warps, each warp's weight exp2(m_w - max)
  // and the weighted l (1 / max(l, 1e-30) with one split)
  float* wts = reinterpret_cast<float*>(mls + WK * 16);  // [WK][16]
  float2* rml = reinterpret_cast<float2*>(wts + WK * 16);  // [16]
  if (tid < 16) {
    float mr = kNegInf, lr = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) mr = fmaxf(mr, mls[w * 16 + tid].x);
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float wt = exp2f(mls[w * 16 + tid].x - mr);
      wts[w * 16 + tid] = wt;
      lr += wt * mls[w * 16 + tid].y;
    }
    rml[tid] = make_float2(mr, parts ? lr : 1.f / fmaxf(lr, 1e-30f));
  }
  __syncthreads();
  for (int e = tid; e < 16 * HD; e += kMmaThreads) {
    const int r = e / HD, c = e - r * HD;
    if (row0 + r >= M) break;  // rows past M come last
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w)
      acc += wts[w * 16 + r] * mo[((size_t)w * 16 + r) * HD + c];
    const size_t orow = out_row(row0 + r);
    if (!parts) {
      out[orow * HD + c] = __float2bfloat16(acc * rml[r].y);
    } else {
      part_o[((size_t)split * rows + orow) * HD + c] = acc;
      if (c == 0) part_ml[(size_t)split * rows + orow] = rml[r];
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(p);
  d[0] = __floats2bfloat162_rn(a.x, a.y);
  d[1] = __floats2bfloat162_rn(a.z, a.w);
}

// The one merge of (O, m, l) partials, n of them a row at part_o
// (n, rows, hd) and part_ml (n, rows): part i weighs
// w_i = exp2((m_i - max_i m_i) * m_log2), m_log2 = 1 where m is in log2
// units (the splits' own) and log2(e) where it is in natural-log units (a
// rank's partial). NORM: out (rows, hd) in T = sum_i w_i O_i /
// max(sum_i w_i l_i, 1e-30), so a part with no visible key adds nothing
// and a row with none anywhere is exactly 0 (the split combine and
// `attention_combine`). Else out (float) takes the unnormalized
// sum_i w_i O_i and out_ml (m, l) = (max_i m_i in natural-log units,
// -1e30 where no part saw a key; sum_i w_i l_i) (the bf16 partial's merge
// of its splits). One thread per 4 outputs (hd % 4 == 0).
template <typename T, bool NORM>
__global__ void __launch_bounds__(128)
mma_combine_kernel(const float* __restrict__ part_o,
                   const float2* __restrict__ part_ml, T* __restrict__ out,
                   float2* __restrict__ out_ml, int rows, int hd, int n,
                   float m_log2) {
  const int per_row = hd / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * per_row) return;
  const int row = (int)(i / per_row);
  const int c = (int)(i - (long long)row * per_row) * 4;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n; ++s)
    mx = fmaxf(mx, part_ml[(size_t)s * rows + row].x);
  float L = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float2 ml = part_ml[(size_t)s * rows + row];
    const float w = exp2f((ml.x - mx) * m_log2);
    const float4 p = *reinterpret_cast<const float4*>(
        part_o + ((size_t)s * rows + row) * hd + c);
    L += w * ml.y;
    a.x += w * p.x;
    a.y += w * p.y;
    a.z += w * p.z;
    a.w += w * p.w;
  }
  if (NORM) {
    const float inv = 1.f / fmaxf(L, 1e-30f);
    a = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  } else if (c == 0) {
    out_ml[row] =
        make_float2(mx == kNegInf ? kNegInf : mx * (m_log2 / kLog2e), L);
  }
  store4(out + (size_t)row * hd + c, a);
}

// Launches mma_combine_kernel over rows x hd.
template <typename T, bool NORM>
int mma_combine(const void* part_o, const void* part_ml, void* out,
                void* out_ml, int rows, int hd, int n, float m_log2,
                cudaStream_t stream) {
  const long long threads = (long long)rows * (hd / 4);
  mma_combine_kernel<T, NORM><<<(unsigned)((threads + 127) / 128), 128, 0,
                                stream>>>(
      (const float*)part_o, (const float2*)part_ml, (T*)out, (float2*)out_ml,
      rows, hd, n, m_log2);
  return (int)cudaGetLastError();
}

template <int HD, int WK, bool PAGED>
int mma_launch(const void* q, const void* k, const void* v, const void* q_pos,
               const void* k_pos, const void* tables, int bs, void* out,
               void* part_o, void* part_ml, int B, int Tq, int Tk, int H,
               int KV, int window, int causal, int n_splits,
               cudaStream_t stream, void* out_ml) {
  using T = MmaTile<HD, WK>;
  constexpr size_t smem = PAGED ? T::SMEM_PAGED : T::SMEM;
  static bool smem_set = false;
  auto kern = mma_attention_kernel<HD, WK, PAGED>;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int M = Tq * (H / KV);
  kern<<<dim3(n_splits, (M + T::BM - 1) / T::BM, B * KV), kMmaThreads, smem,
         stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)q_pos, (const int*)k_pos,
      (const int*)tables, bs, (__nv_bfloat16*)out, (float*)part_o,
      (float2*)part_ml, Tq, Tk, H, KV, window, causal, out_ml != nullptr);
  const cudaError_t err = cudaGetLastError();
  const int rows = B * Tq * H;
  if (err != cudaSuccess) return (int)err;
  if (out_ml != nullptr)
    return mma_combine<float, false>(part_o, part_ml, out, out_ml, rows, HD,
                                     n_splits, 1.f, stream);
  if (n_splits == 1) return (int)err;
  return mma_combine<__nv_bfloat16, true>(part_o, part_ml, out, nullptr, rows,
                                          HD, n_splits, 1.f, stream);
}

// The bf16 path of every attention entry: head_dim in {16, ..., 256}.
// With `tables` (B, Tk / bs) the keys are read through the block table
// (k/v/k_pos are the pools); with nullptr, k/v/k_pos are contiguous rows
// and bs is unused. With `out_ml` (B*Tq*H float2) the call is partial: the
// splits' partials are merged into the fp32 O at `out` (B*Tq*H, hd) and
// (m, l) at `out_ml`, not normalized (part_o / part_ml are then needed at
// any n_splits). Returns cudaGetLastError() after the last launch.
inline int mma_attention(int hd, const void* q, const void* k, const void* v,
                         const void* q_pos, const void* k_pos,
                         const void* tables, int bs, void* out, void* part_o,
                         void* part_ml, int B, int Tq, int Tk, int H, int KV,
                         int window, int causal, int n_splits, void* stream,
                         void* out_ml = nullptr) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV || n_splits < 1 ||
      ((n_splits > 1 || out_ml != nullptr) &&
       (part_o == nullptr || part_ml == nullptr)) ||
      (tables != nullptr && (bs <= 0 || Tk % bs)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // rows of a (batch row, kv head) that fit one warp: 4 warps split keys
  const bool one_warp = Tq * (H / KV) <= 16;
  const bool paged = tables != nullptr;
#define REPRO_MMA_LAUNCH(HD_, WK_)                                           \
  (paged ? mma_launch<HD_, WK_, true>(q, k, v, q_pos, k_pos, tables, bs,     \
                                      out, part_o, part_ml, B, Tq, Tk, H,    \
                                      KV, window, causal, n_splits, s,       \
                                      out_ml)                                \
         : mma_launch<HD_, WK_, false>(q, k, v, q_pos, k_pos, tables, bs,    \
                                       out, part_o, part_ml, B, Tq, Tk, H,   \
                                       KV, window, causal, n_splits, s,      \
                                       out_ml))
#define REPRO_MMA_CASE(HD_) \
  case HD_:                 \
    return one_warp ? REPRO_MMA_LAUNCH(HD_, 4) : REPRO_MMA_LAUNCH(HD_, 1);
  switch (hd) {
    REPRO_MMA_CASE(16)
    REPRO_MMA_CASE(32)
    REPRO_MMA_CASE(64)
    REPRO_MMA_CASE(128)
    REPRO_MMA_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MMA_CASE
#undef REPRO_MMA_LAUNCH
}

}  // namespace
}  // namespace repro
