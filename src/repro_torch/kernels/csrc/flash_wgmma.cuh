// The long-row form of the prefill flash-attention kernel for Hopper
// (sm_90a): bf16 calls whose packed rows per (batch row, kv head), M =
// Tq * G, are at least `split.WGMMA_MIN_ROWS` (the seamless encoder's
// 1024, a 500-token chunk's 2000 at G 4), at head_dim 64 and 128, over a
// contiguous cache row or through the block table. Included by
// flash_attention.cu; the entries pick it by their `kernel` argument, which
// `kernels/split.py: route` decides in Python.
//
// Replaces, for those calls, the Pallas kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention.py (beside the mma.sync kernel of
// attention_mma.cuh, which keeps the short chunks, head_dim 32 and 256).
//
// Bound: by operations. The encoder does 4.3 GFLOP over 8.4 MB, about 512
// operations a byte against the card's 295 in bf16, so the products must
// run at the tensor cores' rate, and on Hopper only wgmma reaches it
// (mma.sync, the other kernel's, tops out far below). Measured, the
// products are then not what bounds a call: the online softmax's exp2 (16
// a clock an SM, both warpgroups' at once), the latencies around it, and a
// fixed cost (setup, the first tile's load, the epilogue's stores) are. What
// the design does:
//
// * Block. One (batch row, kv head), 128 packed rows (row r is (token
//   r / G, head-in-group r % G), token-major, so the G query heads of one
//   kv head share every K/V tile), 288 threads: two consumer warpgroups of
//   64 rows each and one producer warp that issues the loads. Registers:
//   ptxas budgets every region of the kernel at the entry's 168 a thread
//   whether or not setmaxnreg moves registers at run time (compiled both
//   ways on the card: the same allocation and spills), so the key tile is
//   sized to fit that budget instead: 64 keys (S 32 and P 16 registers a
//   thread beside O's HD / 2), no spill at either head_dim.
// * Q. Loaded once by each consumer warpgroup with cp.async, a packed row
//   at a time (Q is not one TMA box when G does not divide 64), straight
//   into the 128-byte swizzle the wgmma descriptor reads.
// * K/V. TMA into a ring of stages (8 at head_dim 64, 4 at 128) with full /
//   empty mbarriers: 2-D tensor maps over (rows, KV * hd), encoded on the
//   host each call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint,
//   so nothing links libcuda), passed as __grid_constant__ parameters (a
//   CUDA graph captures them by value with the capture's addresses, as it
//   does pointers), a box of (64 keys or a block's rows, 64 columns), two
//   boxes a tile at head_dim 128. The producer loads the range's first two
//   tiles at once on entry, while the block reads its k_pos.
// * Visibility. The block stages the k_pos of its key range and lists, in
//   shared memory, the tiles after those first ones that some row can see
//   (flagging the tiles every row sees whole, whose masks are skipped); the
//   producer walks only that list, so a skipped tile's K/V are never read.
//   In a tile the masks apply element by element on the S accumulator:
//   kpos >= 0, causal kpos <= qpos, window kpos > qpos - window; a masked
//   score is -1e30 with probability exactly 0; a slot at or past Tk reads
//   as empty whatever the box brought (past row b's end a box reads row
//   b + 1's keys: TMA zero-fills only past the whole tensor).
// * Products. S = Q K^T: wgmma m64n64k16, both operands from shared memory
//   descriptors. The online softmax runs in base 2 on the accumulator
//   fragments; P goes to bf16 in registers, already in the A fragment
//   layout, and O += P V is a wgmma with A from registers and V read
//   through the descriptor's transpose bit (no transposed copy). Within a
//   warpgroup, S of tile i is issued with P V of tile i - 1, so that
//   product runs during the softmax of S_i. Every branch that holds a wgmma
//   is on warp-uniform values (shuffled from lane 0), which keeps ptxas
//   from serializing them.
// * Epilogue. One split: the normalized bf16 output from registers, the
//   denominator clamped at 1e-30 (a row with no visible key is 0); rows
//   past M are never stored. Split (`split.plan` cuts a small grid's key
//   tiles): fp32 partials that attention_mma.cuh's combine kernel merges.
//   The sequence-sharded decode's `partial` form is not taken (decode
//   never reaches M >= 128).
// * Paged. The producer reads the block table (each box's physical row
//   staged in shared memory with the k_pos): one TMA box a physical
//   block's rows (block sizes that are a multiple of 8 and divide, or are
//   divided by, the 64-key tile; `split.route` gives it multiples of 16,
//   8-row boxes having run slower than the mma.sync kernel), its rows
//   zeroed by the producer warp where the table entry is < 0 (nothing is
//   read). The consumers are the contiguous kernel's.
//
// Keys a call: at most kWgKposMax (every k_pos of the block's range is
// staged); longer rows route to the mma.sync kernel.
#pragma once

#include <cuda.h>

#include "attention_mma.cuh"

namespace repro {
namespace {

constexpr int kWgThreads = 288;     // 2 consumer warpgroups, a producer warp
constexpr int kWgBM = 128;          // packed rows a block
constexpr int kWgBN = 64;           // keys a tile (the S wgmma's N)
constexpr int kWgKposMax = 2048;    // key slots staged: Tk at most this
constexpr int kWgTilesMax = kWgKposMax / kWgBN;
constexpr int kWgAll = 1 << 30;     // tile list flag: every row sees every key
static_assert(kWgTilesMax <= 32, "the walk is listed by one warp's ballot");

template <int HD>
struct WgTile {
  static_assert(HD == 64 || HD == 128, "head_dim 64 or 128");
  static constexpr int ATOMS = HD / 64;  // 128-byte column groups a row
  static constexpr int STAGES = HD == 64 ? 8 : 4;
  static constexpr int Q_BYTES = kWgBM * HD * 2;
  static constexpr int KV_BYTES = kWgBN * HD * 2;  // one K or V tile
  // from the 1024-byte aligned base: Q (atom a of rows at a * kWgBM * 128),
  // then stage s's K at OFF_KV + 2 s KV_BYTES and its V after it (atom a at
  // a * kWgBN * 128), the staged k_pos (and, paged, each box's physical
  // row), the full and empty barriers, the visible-tile list and its flags
  static constexpr int OFF_KV = Q_BYTES;
  static constexpr int OFF_KPOS = OFF_KV + 2 * STAGES * KV_BYTES;
  // paged: the physical row of each box of the range (boxes of 8 or more)
  static constexpr int OFF_PHYS = OFF_KPOS + 4 * kWgKposMax;
  static constexpr int OFF_BAR = OFF_PHYS + 4 * (kWgKposMax / 8);
  static constexpr int OFF_LIST = OFF_BAR + 16 * STAGES;
  static constexpr size_t SMEM =
      OFF_LIST + 4 * (3 * kWgTilesMax + 9) + 1024;  // + the alignment
  static_assert(SMEM <= 232448, "shared memory over the per-block opt-in");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed. Traps after some 2^26
// polls (seconds) rather than hang the card on a lost arrival.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// Box (c0 = column, c1 = row) of a 2-D tensor map into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major operands (Q, K) leave
// the leading offset unused and step 8-row groups by 1024 bytes; the
// MN-major V steps 64-column atoms by the leading offset and 8-key groups
// by the stride offset.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, fp32) (+)= a (64 x 16) * b (16 x 64), both bf16 from
// shared memory descriptors, K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) += a (64 x 16, bf16 fragments in registers) * b
// (16 x 64, bf16 from a shared memory descriptor, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 fragments in registers) * b
// (16 x 128, bf16 from a shared memory descriptor, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (64 x kWgBN) = Q K^T over head_dim HD: Q's rows at sq, the K tile at
// sk, both in 64-column atoms (rows 128 bytes apart, atoms `rows` x 128
// bytes apart).
template <int HD>
__device__ __forceinline__ void wg_qk(float (&s)[kWgBN / 2], uint32_t sq,
                                      uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(
        s, wg_desc(sq + (kk / 4) * (kWgBM * 128) + (kk % 4) * 32, 16, 1024),
        wg_desc(sk + (kk / 4) * (kWgBN * 128) + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// O (64 x HD) += P V: P (64 x kWgBN) in registers, V the tile at sv.
template <int HD>
__device__ __forceinline__ void wg_pv(float (&o)[HD / 2],
                                      const uint32_t (&pa)[kWgBN / 16][4],
                                      uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    const uint64_t dv = wg_desc(sv + kk * 16 * 128, kWgBN * 128, 1024);
    if constexpr (HD == 64)
      wgmma_rs_n64(o, pa[kk], dv);
    else
      wgmma_rs_n128(o, pa[kk], dv);
  }
}

// The online softmax of one tile's S (raw scores, the accumulator
// fragments: element (j, c) is row (c < 2 ? a : b), key 8j + 2 tq + (c &
// 1)): masks (skipped when the tile entry `te` says every row sees every
// key), the row max in log2 units into m, the weight of the old rows into
// alpha, l updated, and s turned into P. te: the tile's entry in the
// visible list (its index in the block's key range); kp: the staged k_pos
// of key 2 tq of the range. The exponentials take turns with the other
// consumer warpgroup's (named barriers `turn`, then `next`; next < 0: the
// other has no turn left), so each runs at the SM's whole exp2 rate while
// the other's latencies (S, shuffles, packing) overlap it.
__device__ __forceinline__ void wg_softmax(float (&s)[kWgBN / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           int te, const int* kp, int qpa,
                                           int qpb, int causal, int window,
                                           float scale, int turn, int next) {
  const bool all = te & kWgAll;
  if (!all) {
    const int* kp_t = kp + (te & (kWgAll - 1)) * kWgBN;
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
      const int2 k2 = *reinterpret_cast<const int2*>(kp_t + 8 * j);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!mma_visible(c & 1 ? k2.y : k2.x, c < 2 ? qpa : qpb, causal,
                         window))
          s[4 * j + c] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf}, mneg[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < kWgBN / 2; ++x)
    mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h] * scale);
    alpha[h] = fast_exp2(m[h] - mn);
    m[h] = mn;
    mneg[h] = -mn;
  }
  asm volatile("bar.sync %0, 256;\n" ::"r"(turn) : "memory");
  if (all) {
#pragma unroll
    for (int x = 0; x < kWgBN / 2; ++x)
      s[x] = fast_exp2(fmaf(s[x], scale, mneg[(x >> 1) & 1]));
  } else {
#pragma unroll
    for (int x = 0; x < kWgBN / 2; ++x)
      s[x] = s[x] != kNegInf ? fast_exp2(fmaf(s[x], scale, mneg[(x >> 1) & 1]))
                             : 0.f;
  }
  if (next >= 0) asm volatile("bar.arrive %0, 256;\n" ::"r"(next) : "memory");
#pragma unroll
  for (int x = 0; x < kWgBN / 2; ++x) rsum[(x >> 1) & 1] += s[x];
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
}

// q/out: (B, Tq, H, HD); q_pos: (B, Tq). Contiguous: tm_k/tm_v map k/v as
// (B*Tk, KV*HD) rows with boxes of (kWgBN, 64), k_pos (B, Tk). Paged:
// they map the pools as (NB*bs, KV*HD) with boxes of (min(bs, kWgBN), 64),
// k_pos is the pool's (NB, bs) position map and tables (B, MB) the block
// tables, Tk = MB * bs. part_o / part_ml as the mma.sync kernel's (used
// with several splits only). Grid (n_splits, ceil(M / kWgBM), B*KV) of
// kWgThreads.
template <int HD, bool PAGED>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_attention_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ q,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const int* __restrict__ tables, int bs, int MB,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_o, float2* __restrict__ part_ml,
                    int Tq, int Tk, int H, int KV, int window, int causal) {
  using T = WgTile<HD>;
  constexpr int ST = T::STAGES;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem =
      wg_smem_raw + ((1024 - (smem_addr(wg_smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  int* kpos_s = reinterpret_cast<int*>(smem + T::OFF_KPOS);
  int* phys_s = reinterpret_cast<int*>(smem + T::OFF_PHYS);
  const uint32_t full0 = s_base + T::OFF_BAR, empty0 = full0 + 8 * ST;
  // the visible tiles, by index in the block's key range, kWgAll set where
  // every row sees every key
  int* list = reinterpret_cast<int*>(smem + T::OFF_LIST);
  int* any_f = list + kWgTilesMax;  // a tile some row sees a key of
  int* all_f = any_f + kWgTilesMax;  // a tile every row sees whole
  int* misc = all_f + kWgTilesMax;   // tiles listed; per warp max, min q_pos

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int b = blockIdx.z / KV, kvh = blockIdx.z % KV;
  const int G = H / KV, M = Tq * G;
  const int row0 = blockIdx.y * kWgBM, tid = threadIdx.x;
  const int n_tiles = (Tk + kWgBN - 1) / kWgBN;
  const int t_begin = (int)((long long)split * n_tiles / n_splits);
  const int t_end = (int)((long long)(split + 1) * n_tiles / n_splits);
  const int nt = t_end - t_begin, s0 = t_begin * kWgBN;

  // Paged, tile t's box j (rows [j R, (j + 1) R) of the tile, from
  // logical slot t*kWgBN + j R) comes from physical row `box_row(t, j)`
  // of the pool, -1 where the table names no block.
  const int R = PAGED ? (bs < kWgBN ? bs : kWgBN) : kWgBN, nbox = kWgBN / R;
  auto box_row = [&](int t, int j) {
    const int s = t * kWgBN + j * R, blk = s / bs;
    const int e = blk < MB ? tables[(size_t)b * MB + blk] : -1;
    return e >= 0 ? e * bs + s % bs : -1;
  };
  // Walked tile i is tile t of the call, in stage i % ST: the producer
  // warp waits for the stage to be free, then loads K and V by TMA; paged,
  // lane j < nbox its box from row `phys` (the rows of a box with no block
  // zeroed).
  auto load = [&](int i, int t, int lane, int phys) {
    const int st = i % ST;
    const uint32_t full = full0 + 8 * st;
    const uint32_t sk = s_base + T::OFF_KV + 2 * st * T::KV_BYTES;
    const uint32_t sv = sk + T::KV_BYTES;
    mbar_wait(empty0 + 8 * st, ((i / ST) & 1) ^ 1);
    if (!PAGED) {
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * T::KV_BYTES);
        const int row = b * Tk + t * kWgBN;
#pragma unroll
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_2d(sk + a * kWgBN * 128, &tm_k, full, kvh * HD + a * 64,
                      row);
          tma_load_2d(sv + a * kWgBN * 128, &tm_v, full, kvh * HD + a * 64,
                      row);
        }
      }
      return;
    }
    if (lane >= nbox) phys = -1;
    const unsigned ok = __ballot_sync(0xffffffffu, phys >= 0);
    const unsigned bad = ~ok & ((nbox < 32 ? 1u << nbox : 0u) - 1u);
    if (bad) {  // zero the rows of boxes with no block, K and V
      for (unsigned m = bad; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        for (int w = lane; w < R * 8; w += 32) {  // 16-byte chunks of a row
          const uint32_t off = (j * R + (w >> 3)) * 128 + (w & 7) * 16;
#pragma unroll
          for (int a = 0; a < T::ATOMS; ++a)
            asm volatile(
                "st.shared.v4.u32 [%0], {%2, %2, %2, %2};\n"
                "st.shared.v4.u32 [%1], {%2, %2, %2, %2};\n" ::"r"(
                    sk + a * kWgBN * 128 + off),
                "r"(sv + a * kWgBN * 128 + off), "r"(0)
                : "memory");
        }
      }
      fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_tx(full, __popc(ok) * R * 128 * T::ATOMS * 2);
    __syncwarp();
    if (phys >= 0) {
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a) {
        tma_load_2d(sk + a * kWgBN * 128 + lane * R * 128, &tm_k, full,
                    kvh * HD + a * 64, phys);
        tma_load_2d(sv + a * kWgBN * 128 + lane * R * 128, &tm_v, full,
                    kvh * HD + a * 64, phys);
      }
    }
  };
  // The first tiles of the range (two, at most a stage each) are walked
  // whatever their visibility (their masks zero what no row sees) and
  // loaded at once by the producer warp, before the k_pos that decide the
  // rest are read: the first load's latency overlaps the setup.
  constexpr int kFirst = 2 < ST ? 2 : ST;
  const int n_first = nt < kFirst ? nt : kFirst;
  if (tid >= 256) {
    const int lane = tid & 31;
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        mbar_init(full0 + 8 * s, 1);   // the producer's arrival (+ bytes)
        mbar_init(empty0 + 8 * s, 8);  // each consumer warp's
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    int ph[kFirst];  // paged: both tiles' table entries read at once
#pragma unroll
    for (int i = 0; i < kFirst; ++i)
      ph[i] = PAGED && i < n_first && lane < nbox ? box_row(t_begin + i, lane)
                                                  : -1;
#pragma unroll
    for (int i = 0; i < kFirst; ++i)
      if (i < n_first) load(i, t_begin + i, lane, ph[i]);
  }

  // Setup, its loads in flight together: the consumers' Q (cp.async, waited
  // for before their first product), the block's k_pos (-1 past Tk; paged,
  // through the block table, -1 where the entry is < 0) and its rows'
  // q_pos.
  if (tid < 256) {
    // each consumer warpgroup its own 64 rows: packed row r of the block is
    // q[b, t, kvh*G + g], r = t*G + g; rows past M zero; 16-byte chunk ch
    // of row r at its 128-byte swizzle place
    const int r0 = tid < 128 ? 0 : 64;
    for (int c = tid % 128; c < 64 * (HD / 8); c += 128) {
      const int r = r0 + c / (HD / 8), ch = c % (HD / 8), gr = row0 + r;
      const bool ok = gr < M;
      const __nv_bfloat16* src = q;
      if (ok) {
        const int t = gr / G;
        src = q + (((size_t)b * Tq + t) * H + (size_t)kvh * G + (gr - t * G)) *
                      HD + ch * 8;
      }
      cp_async16(s_base + (ch / 8) * (kWgBM * 128) + r * 128 +
                     ((ch % 8) ^ (r % 8)) * 16,
                 src, ok);
    }
    cp_async_commit();
  }
  constexpr int KPT = (kWgKposMax + kWgThreads - 1) / kWgThreads;
  int kp[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int i = tid + j * kWgThreads, s = s0 + i;
    kp[j] = -1;
    if (i < nt * kWgBN && s < Tk) {
      if (PAGED) {
        const int blk = tables[(size_t)b * MB + s / bs];
        const int row = blk >= 0 ? blk * bs + s % bs : -1;
        kp[j] = row >= 0 ? k_pos[row] : -1;
        if (i % R == 0) phys_s[i / R] = row;
      } else {
        kp[j] = k_pos[(size_t)b * Tk + s];
      }
    } else if (PAGED && i < nt * kWgBN && i % R == 0) {
      phys_s[i / R] = -1;  // a box past Tk
    }
  }
  {  // the block's query range: per warp of the first four, then combined
    const bool ok = tid < kWgBM && row0 + tid < M;
    const int qp = ok ? q_pos[(size_t)b * Tq + (row0 + tid) / G] : 0;
    int qmx = ok ? qp : -2147483647 - 1, qmn = ok ? qp : 2147483647;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmx = max(qmx, __shfl_xor_sync(0xffffffffu, qmx, o));
      qmn = min(qmn, __shfl_xor_sync(0xffffffffu, qmn, o));
    }
    if (tid < kWgBM && (tid & 31) == 0) {
      misc[1 + 2 * (tid >> 5)] = qmx;
      misc[2 + 2 * (tid >> 5)] = qmn;
    }
  }
  if (tid < kWgTilesMax) {
    any_f[tid] = 0;
    all_f[tid] = 1;
  }
  __syncthreads();
  {
    const int qmax = max(max(misc[1], misc[3]), max(misc[5], misc[7]));
    const int qmin = min(min(misc[2], misc[4]), min(misc[6], misc[8]));
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int i = tid + j * kWgThreads;
      if (i < nt * kWgBN) {
        const int k_ = kp[j];
        kpos_s[i] = k_;
        if (k_ >= 0 && (!causal || k_ <= qmax) &&
            (window == 0 || k_ > qmin - window))
          any_f[i / kWgBN] = 1;
        if (!(k_ >= 0 && (!causal || k_ <= qmin) &&
              (window == 0 || k_ > qmax - window)))
          all_f[i / kWgBN] = 0;
      }
    }
  }
  __syncthreads();
  if (tid < 32) {  // the walk: the first tiles, then the visible ones
    const bool f = tid < nt && (tid < n_first || any_f[tid]);
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (f)
      list[__popc(bal & ((1u << tid) - 1u))] =
          tid | (all_f[tid] ? kWgAll : 0);
    if (tid == 0) misc[0] = __popc(bal);
  }
  __syncthreads();
  // warp-uniform as the compiler sees them (a shuffle from lane 0), so that
  // no wgmma sits in a divergent path
  const int n_vis = __shfl_sync(0xffffffffu, misc[0], 0);
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    const int lane = tid & 31;
    for (int i = n_first; i < n_vis; ++i) {
      const int tr = list[i] & (kWgAll - 1);  // in the range
      load(i, t_begin + tr, lane,
           PAGED && lane < nbox ? phys_s[tr * nbox + lane] : -1);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int cw = wg, ctid = tid % 128;  // rows 64 cw + [0, 64)
  const int warp = ctid >> 5, lane = ctid & 31, quad = lane >> 2,
            tq = lane & 3;
  const uint32_t s_q = s_base + 64 * cw * 128;  // this warpgroup's Q rows
  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

  // this thread's rows of the fragments: ra and ra + 8
  const int ra = row0 + 64 * cw + 16 * warp + quad, rb = ra + 8;
  const int qpa = ra < M ? q_pos[(size_t)b * Tq + ra / G] : -1;
  const int qpb = rb < M ? q_pos[(size_t)b * Tq + rb / G] : -1;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale = kLog2e / sqrtf((float)HD);
  // P of the tile before, in the A fragment layout (k-step kk: keys
  // 16 kk + [0, 16))
  uint32_t pa[kWgBN / 16][4];
  float s[kWgBN / 2], alpha[2];
  auto s_of = [&](int i) {  // S = Q K^T of visible tile i, issued
    const uint32_t sk = s_base + T::OFF_KV + 2 * (i % ST) * T::KV_BYTES;
    mbar_wait(full0 + 8 * (i % ST), (i / ST) & 1);
    wgmma_fence();
    wg_qk<HD>(s, s_q, sk);
    wgmma_commit();
  };
  auto v_of = [&](int i) {
    return s_base + T::OFF_KV + (2 * (i % ST) + 1) * T::KV_BYTES;
  };
  auto release = [&](int i) {  // the stage of tile i is read
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % ST));
  };
  auto rescale_pack = [&]() {  // O to the new max; P to bf16
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Tile i: S_i = Q K_i^T is issued, then O += P_{i-1} V_{i-1}, so at
  // head_dim 64 the second product runs while the softmax of S_i does;
  // tile i - 1's stage is released once its product is done. Tile 0 is
  // peeled off. The two warpgroups' exponentials alternate (barriers
  // 4 + cw), the first warpgroup's first.
  const int turn = 4 + cw, other = 5 - cw;
  auto next = [&](int i) { return cw == 0 || i + 1 < n_vis ? other : -1; };
  if (cw == 1 && n_vis > 0)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
  if (n_vis > 0) {
    s_of(0);
    reg_fence(s);
    wgmma_wait<0>();
    reg_fence(s);
    wg_softmax(s, m, l, alpha, list[0], kpos_s + 2 * tq, qpa, qpb,
               causal, window, scale, turn, next(0));
    rescale_pack();
  }
  for (int i = 1; i < n_vis; ++i) {
    if constexpr (HD == 64) {
      s_of(i);
      reg_fence(o);
      wg_pv<HD>(o, pa, v_of(i - 1));
      wgmma_commit();
      reg_fence(o);
      reg_fence(s);
      wgmma_wait<1>();  // S_i; P_{i-1} V_{i-1} runs on through the softmax
      reg_fence(s);
      wg_softmax(s, m, l, alpha, list[i], kpos_s + 2 * tq, qpa, qpb,
                 causal, window, scale, turn, next(i));
      wgmma_wait<0>();
      reg_fence(o);
      release(i - 1);
    } else {
      // at head_dim 128, P_{i-1} held through the softmax would spill: both
      // products are waited for first
      wgmma_fence();
      reg_fence(o);
      wg_pv<HD>(o, pa, v_of(i - 1));
      wgmma_commit();
      s_of(i);
      reg_fence(o);
      reg_fence(s);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(s);
      release(i - 1);
      wg_softmax(s, m, l, alpha, list[i], kpos_s + 2 * tq, qpa, qpb,
                 causal, window, scale, turn, next(i));
    }
    rescale_pack();
  }
  if (n_vis > 0) {  // the last tile's P V
    wgmma_fence();
    reg_fence(o);
    wg_pv<HD>(o, pa, v_of(n_vis - 1));
    wgmma_commit();
    reg_fence(o);
    wgmma_wait<0>();
    reg_fence(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t rows = (size_t)(gridDim.z / KV) * Tq * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= M) continue;
    const int tok = r / G;
    const size_t orow = ((size_t)b * Tq + tok) * H + (size_t)kvh * G +
                        (r - tok * G);
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst = out + orow * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    } else {
      float* dst = part_o + ((size_t)split * rows + orow) * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (tq == 0)
        part_ml[(size_t)split * rows + orow] = make_float2(m[h], l[h]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (nullptr if
// the driver has none).
using WgEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline WgEncodeFn wg_encode_fn() {
  static WgEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WgEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) bf16 matrix, rows `cols` apart, in boxes of (box_rows,
// 64) with the 128-byte swizzle; rows past the end read as zeros.
inline bool wg_encode(CUtensorMap* map, const void* base, uint64_t rows,
                      uint64_t cols, uint32_t box_rows) {
  const WgEncodeFn fn = wg_encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool PAGED>
int wg_launch(const void* q, const void* k, const void* v, const void* q_pos,
              const void* k_pos, const void* tables, int bs, int MB, int NB,
              void* out, void* part_o, void* part_ml, int B, int Tq, int Tk,
              int H, int KV, int window, int causal, int n_splits,
              cudaStream_t stream) {
  using T = WgTile<HD>;
  static bool smem_set = false;
  auto kern = wg_attention_kernel<HD, PAGED>;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  CUtensorMap tm_k, tm_v;
  const uint64_t rows = PAGED ? (uint64_t)NB * bs : (uint64_t)B * Tk;
  const uint32_t box = PAGED && bs < kWgBN ? (uint32_t)bs : (uint32_t)kWgBN;
  if (!wg_encode(&tm_k, k, rows, (uint64_t)KV * HD, box) ||
      !wg_encode(&tm_v, v, rows, (uint64_t)KV * HD, box))
    return (int)cudaErrorInvalidValue;
  const int M = Tq * (H / KV);
  kern<<<dim3(n_splits, (M + kWgBM - 1) / kWgBM, B * KV), kWgThreads,
         T::SMEM, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (const int*)q_pos,
      (const int*)k_pos, (const int*)tables, bs, MB, (__nv_bfloat16*)out,
      (float*)part_o, (float2*)part_ml, Tq, Tk, H, KV, window, causal);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  return mma_combine<__nv_bfloat16, true>(part_o, part_ml, out, nullptr,
                                          B * Tq * H, HD, n_splits, 1.f,
                                          stream);
}

// The long-row path of the bf16 prefill entries: head_dim 64 or 128, Tk at
// most kWgKposMax; paged (tables != nullptr: k/v/k_pos the pools of NB
// blocks), a block size that is a multiple of 8 and divides or is divided
// by kWgBN. Returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue for a call it does not take (encoding the tensor
// maps included).
inline int wg_attention(int hd, const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos,
                        const void* tables, int bs, int MB, int NB, void* out,
                        void* part_o, void* part_ml, int B, int Tq, int Tk,
                        int H, int KV, int window, int causal, int n_splits,
                        void* stream) {
  const bool paged = tables != nullptr;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Tk > kWgKposMax || KV <= 0 || H % KV ||
      n_splits < 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)) ||
      (paged && (bs <= 0 || bs % 8 || NB <= 0 || MB * bs != Tk ||
                 (bs % kWgBN && kWgBN % bs))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_WG_LAUNCH(HD_)                                                 \
  (paged ? wg_launch<HD_, true>(q, k, v, q_pos, k_pos, tables, bs, MB, NB,  \
                                out, part_o, part_ml, B, Tq, Tk, H, KV,      \
                                window, causal, n_splits, s)                 \
         : wg_launch<HD_, false>(q, k, v, q_pos, k_pos, tables, bs, MB, NB, \
                                 out, part_o, part_ml, B, Tq, Tk, H, KV,     \
                                 window, causal, n_splits, s))
  switch (hd) {
    case 64: return REPRO_WG_LAUNCH(64);
    case 128: return REPRO_WG_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WG_LAUNCH
}

}  // namespace
}  // namespace repro
