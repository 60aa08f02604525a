// RG-LRU linear recurrence for Hopper (sm_90a), in fp32:
// h_t = a_t * h_{t-1} + bx_t over t, independently in every width lane.
//
// Replaces the Pallas kernel `rglru_scan_kernel` of
// src/repro/kernels/rglru_scan.py. Two entries share one body:
//
//   rglru_scan        a and bx given (fp32): the TPU kernel's function.
//   rglru_gated_scan  RecurrentGemma's gated recurrence (the JAX package's
//                     `models/rglru.py: rglru_core` after its two gate
//                     products): a and bx are formed in the load stage from
//                     the gate pre-activations ga = x @ w_a, gi = x @ w_i,
//                     x (fp32 or bf16) and the per-lane lam, b_a, b_i:
//                       r = sigmoid(ga + b_a), i = sigmoid(gi + b_i),
//                       a = exp(-8 softplus(lam) r),
//                       bx = sqrt(max(1 - a^2, 1e-9)) (i x),
//                     and y is stored in x's dtype. One launch takes the
//                     place of the eager chain of some twenty ops, each of
//                     which wrote an fp32 (B, T, W) temporary.
//
// Bound: device-memory bytes, each input read once and each output written
// once, with a handful of operations an element; at a serving chunk's or a
// decode step's size (a few MB), the launch and one round trip to memory.
//
// Design: a segmented scan over time. A block owns LG groups of VEC width
// lanes (VEC = 4 where W % 4 == 0 and the operands are 16-byte aligned:
// each thread then moves 16 bytes of fp32, or 8 of bf16, a load) of one
// batch row, and splits its tile of time into S segments of `len` steps,
// one segment a thread. Three passes:
//   1. every thread loads its segment into registers (all loads issued
//      before any use, so one round trip to memory covers the segment),
//      forms a and bx there, and folds the segment into the pair
//      (A = prod a, H = the segment's h_end from h = 0);
//   2. the pairs go to shared memory and one thread a lane forms the
//      carries in segment order, carry_s = A_s carry_{s-1} + H_s, from the
//      tile's incoming h (h0 first), which it keeps in a register; with
//      many segments (Q > 1) in two levels: Q groups of segments folded
//      into pairs in parallel, the groups' carries in order, then each
//      group's segment carries in parallel;
//   3. every thread runs its segment again from its incoming carry, from
//      the registers it kept, and stores each h_t; the thread that holds
//      step T - 1 stores h_T.
// Where T is longer than S * len, the block walks T in tiles and carries h
// from tile to tile. Steps past T and lanes past W are the identity
// (a = 1, bx = 0) and are not stored: no W or T multiple is required, and
// nothing divides by A, so a lane with a = 0 gives h_t = bx_t. The host
// (kernels/rglru_scan.py: launch_shape) picks LG, S and len so that both
// a serving chunk (B 2, T 16) and a long prefill (B 1, T 512) fill the
// SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxGroups = 64;         // lane groups a block
constexpr float kC = 8.f;              // RecurrentGemma's c

// Steps a thread holds in registers: a thread may use 128 registers at 512
// threads a block, and the gated entry's three raw operands and its gate
// arithmetic would crowd 8 steps of 4 lanes into spills.
template <bool GATED>
__host__ __device__ constexpr int max_steps() {
  return GATED ? 4 : 8;
}

// Loads, unpacking into fp32, and stores of VEC consecutive elements. The
// vector loads are streaming (evict first) and ask L2 to fetch 256 bytes: a
// block reads 64-128 contiguous bytes of a row a step at the main shapes,
// and the block beside it the next ones.
template <typename T, int VEC>
struct Io;

template <>
struct Io<float, 4> {
  using Raw = float4;
  static __device__ Raw load(const float* p) {
    float4 v;
    asm("ld.global.cs.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
  static __device__ void unpack(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Io<float, 1> {
  using Raw = float;
  static __device__ Raw load(const float* p) { return *p; }
  static __device__ void unpack(const Raw& r, float* v) { v[0] = r; }
  static __device__ void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Io<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ Raw load(const __nv_bfloat16* p) {
    uint2 v;
    asm("ld.global.cs.L2::256B.v2.u32 {%0, %1}, [%2];"
        : "=r"(v.x), "=r"(v.y) : "l"(p));
    return v;
  }
  // a bf16 is the top half of an fp32; element 0 is the low half of a word
  static __device__ void unpack(const Raw& r, float* v) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  static __device__ void store(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), u);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  static __device__ void unpack(const Raw& r, float* v) {
    v[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  static __device__ void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// rglru_scan: a, bx fp32. rglru_gated_scan: ga, gi, x of type TX and the
// per-lane lam, b_a, b_i (W,) fp32. h0, hT (B, W) fp32; y (B, T, W) of type
// TX (fp32 for rglru_scan).
template <typename TX>
struct Operands {
  const TX* a;       // rglru_scan: a;  gated: ga
  const TX* b;       // rglru_scan: bx; gated: gi
  const TX* x;       // gated only
  const float* lam;  // gated only
  const float* b_a;  // gated only
  const float* b_i;  // gated only
  const float* h0;
  TX* y;
  float* hT;
};

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// Grid (ceil(ceil(W / VEC) / LG), B), LG * S threads: thread (g, s) =
// (tid % LG, tid / LG) owns lanes [(blockIdx.x * LG + g) * VEC, + VEC) and
// steps [t0 + s * len, + len) of each tile t0; Q carry groups (1: serial).
template <typename TX, bool GATED, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rglru_kernel(const Operands<TX> op, int T, int W, int LG, int S, int len,
             int Q) {
  constexpr int L = max_steps<GATED>();
  using In = Io<TX, VEC>;
  using F32 = Io<float, VEC>;
  __shared__ __align__(16) float sA[kMaxThreads * VEC];
  __shared__ __align__(16) float sH[kMaxThreads * VEC];
  __shared__ float sGA[kMaxThreads], sGH[kMaxThreads];   // Q > 1: groups

  const int tid = threadIdx.x, g = tid % LG, seg = tid / LG;
  const int lanes = LG * VEC, block_lane = blockIdx.x * lanes;
  const int lane = block_lane + g * VEC;
  const bool live = lane < W;
  const size_t bw = (size_t)blockIdx.y * W;
  const size_t row = bw * T + lane;

  // Loads whose values are used only after the first step loads are issued,
  // so that they share that round trip to memory: the gates' per-lane
  // constants (softplus taken after the step loads), and h0, in registers
  // (S 1: the thread's own lanes; S > 1: the lanes j = tid + k blockDim
  // whose carries this thread forms in pass 2, at most VEC / S <= 2).
  constexpr int K = VEC == 4 ? 2 : 1;
  float lam[VEC], ba[VEC], bi[VEC], h[VEC], carry[K];
#pragma unroll
  for (int v = 0; v < VEC; ++v) lam[v] = ba[v] = bi[v] = h[v] = 0.f;
  if constexpr (GATED) {
    if (live) {
      F32::unpack(F32::load(op.lam + lane), lam);
      F32::unpack(F32::load(op.b_a + lane), ba);
      F32::unpack(F32::load(op.b_i + lane), bi);
    }
  }
  if (S == 1) {
    if (live) F32::unpack(F32::load(op.h0 + bw + lane), h);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * blockDim.x;
      carry[k] = j < lanes && block_lane + j < W ? op.h0[bw + block_lane + j]
                                                 : 0.f;
    }
  }

  for (int t0 = 0; t0 < T; t0 += S * len) {
    const int ts = t0 + seg * len;
    // the segment's steps that exist: steps past T and lanes past W are
    // neither loaded, folded nor stored
    const int n = live ? max(0, min(len, T - ts)) : 0;
    const size_t base = row + (size_t)ts * W;
    // load stage: every load of the segment issued before any use
    float a[L][VEC], bx[L][VEC];
    if constexpr (GATED) {
      typename In::Raw ra[L], rb[L], rx[L];
#pragma unroll
      for (int u = 0; u < L; ++u)
        if (u < n) {
          ra[u] = In::load(op.a + base + u * W);
          rb[u] = In::load(op.b + base + u * W);
          rx[u] = In::load(op.x + base + u * W);
        }
      // -c softplus(lam), torch's softplus (threshold 20)
      float nsp[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        nsp[v] = -kC * (lam[v] > 20.f ? lam[v] : log1pf(expf(lam[v])));
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (u >= n) continue;
        float ga[VEC], gi[VEC], xv[VEC];
        In::unpack(ra[u], ga);
        In::unpack(rb[u], gi);
        In::unpack(rx[u], xv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float r = sigmoid(ga[v] + ba[v]);
          const float i = sigmoid(gi[v] + bi[v]);
          const float av = expf(nsp[v] * r);
          // 1 - a^2 rounded as the plain version rounds it (no fused
          // multiply-add: near a = 1 the difference is cancellation)
          const float keep = fmaxf(__fsub_rn(1.f, __fmul_rn(av, av)), 1e-9f);
          a[u][v] = av;
          bx[u][v] = sqrtf(keep) * (i * xv[v]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < L; ++u)
        if (u < n) {
          In::unpack(In::load(op.a + base + u * W), a[u]);
          In::unpack(In::load(op.b + base + u * W), bx[u]);
        }
    }

    if (S > 1) {
      // pass 1: the segment's pair (A, H)
      float A[VEC], H[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) A[v] = 1.f, H[v] = 0.f;
#pragma unroll
      for (int u = 0; u < L; ++u)
        if (u < n)
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            A[v] *= a[u][v];
            H[v] = fmaf(a[u][v], H[v], bx[u][v]);
          }
      float* pa = sA + seg * lanes + g * VEC;
      float* ph = sH + seg * lanes + g * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) pa[v] = A[v], ph[v] = H[v];
      __syncthreads();
      // pass 2: carries in segment order; sH[s] becomes segment s's
      // incoming h, carry the tile's outgoing h
      if (Q == 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = tid + k * blockDim.x;
          if (j >= lanes) continue;
          float c = carry[k];
#pragma unroll 4
          for (int s = 0; s < S; ++s) {
            const float cin = c;
            c = fmaf(sA[s * lanes + j], c, sH[s * lanes + j]);
            sH[s * lanes + j] = cin;
          }
          carry[k] = c;
        }
      } else {
        // in two levels, Q groups of G segments: thread (j, q) folds group
        // q into one pair, thread (j, 0) forms the groups' carries (it owns
        // lane j's carry: lanes * Q <= blockDim), and thread (j, q) then
        // forms its group's segment carries from the group's
        const int j = tid % lanes, q = tid / lanes, G = (S + Q - 1) / Q;
        const int s0 = min(S, q * G), s1 = min(S, s0 + G);
        if (q < Q) {
          float ga = 1.f, gh = 0.f;
          for (int s = s0; s < s1; ++s) {
            gh = fmaf(sA[s * lanes + j], gh, sH[s * lanes + j]);
            ga *= sA[s * lanes + j];
          }
          sGA[q * lanes + j] = ga, sGH[q * lanes + j] = gh;
        }
        __syncthreads();
        if (q == 0) {
          float c = carry[0];
          for (int r = 0; r < Q; ++r) {
            const float cin = c;
            c = fmaf(sGA[r * lanes + j], c, sGH[r * lanes + j]);
            sGH[r * lanes + j] = cin;
          }
          carry[0] = c;
        }
        __syncthreads();
        if (q < Q) {
          float c = sGH[q * lanes + j];
          for (int s = s0; s < s1; ++s) {
            const float cin = c;
            c = fmaf(sA[s * lanes + j], c, sH[s * lanes + j]);
            sH[s * lanes + j] = cin;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < VEC; ++v) h[v] = ph[v];
    }

    // pass 3: the segment again from its incoming h, storing every h_t
#pragma unroll
    for (int u = 0; u < L; ++u)
      if (u < n) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) h[v] = fmaf(a[u][v], h[v], bx[u][v]);
        In::store(op.y + base + u * W, h);
      }
    if (n > 0 && ts + n == T) F32::store(op.hT + bw + lane, h);   // h_{T-1}
    if (S > 1 && t0 + S * len < T) __syncthreads();   // sA, sH reused
  }
}

template <typename TX, bool GATED>
int launch(const Operands<TX>& op, int B, int T, int W, int vec, int LG,
           int S, int len, int Q, cudaStream_t stream) {
  constexpr int L = max_steps<GATED>();
  if (B <= 0 || T <= 0 || W <= 0 || !(vec == 1 || (vec == 4 && W % 4 == 0))
      || LG <= 0 || LG > kMaxGroups || S <= 0 || LG * S > kMaxThreads
      || len <= 0 || len > L || Q <= 0 || (Q > 1 && vec * Q > S))
    return (int)cudaErrorInvalidValue;
  const int groups = (W + vec - 1) / vec;
  const dim3 grid((groups + LG - 1) / LG, B);
  if (vec == 4)
    rglru_kernel<TX, GATED, 4><<<grid, LG * S, 0, stream>>>(op, T, W, LG, S,
                                                           len, Q);
  else
    rglru_kernel<TX, GATED, 1><<<grid, LG * S, 0, stream>>>(op, T, W, LG, S,
                                                           len, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps a thread of either entry holds (the largest `len`).
extern "C" int rglru_max_steps(int gated) {
  return gated ? max_steps<true>() : max_steps<false>();
}

// All operands fp32 and contiguous; vec 4 needs W % 4 == 0 and 16-byte
// aligned operands. Returns cudaGetLastError() after the launch.
extern "C" int rglru_scan(const void* a, const void* bx, const void* h0,
                          void* y, void* hT, int B, int T, int W, int vec,
                          int LG, int S, int len, int Q, void* stream) {
  const Operands<float> op{(const float*)a, (const float*)bx, nullptr,
                           nullptr, nullptr, nullptr, (const float*)h0,
                           (float*)y, (float*)hT};
  return launch<float, false>(op, B, T, W, vec, LG, S, len, Q,
                              (cudaStream_t)stream);
}

// dtype 0: ga, gi, x, y fp32; 1: bf16. lam, b_a, b_i (W,), h0 and hT
// (B, W) fp32; all contiguous. Returns cudaGetLastError() after the launch.
extern "C" int rglru_gated_scan(int dtype, const void* ga, const void* gi,
                                const void* x, const void* lam,
                                const void* b_a, const void* b_i,
                                const void* h0, void* y, void* hT, int B,
                                int T, int W, int vec, int LG, int S, int len,
                                int Q, void* stream) {
  if (dtype == 0) {
    const Operands<float> op{(const float*)ga, (const float*)gi,
                             (const float*)x, (const float*)lam,
                             (const float*)b_a, (const float*)b_i,
                             (const float*)h0, (float*)y, (float*)hT};
    return launch<float, true>(op, B, T, W, vec, LG, S, len, Q,
                               (cudaStream_t)stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const Operands<bf> op{(const bf*)ga, (const bf*)gi, (const bf*)x,
                          (const float*)lam, (const float*)b_a,
                          (const float*)b_i, (const float*)h0, (bf*)y,
                          (float*)hT};
    return launch<bf, true>(op, B, T, W, vec, LG, S, len, Q,
                            (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
