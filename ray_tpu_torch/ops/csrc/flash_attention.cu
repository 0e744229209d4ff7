// Flash attention for Hopper (sm_90a): forward (B1) and backward (B2, B3).
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/attention.py:
//   B1 `_fwd_kernel` (:79), launched by `_flash_fwd` (:272);
//   B2 `_bwd_dkdv_kernel` (:134), launched by `_flash_bwd` (:318), with the
//      GQA sum over the group that follows it (:344-346) folded in;
//   B3 `_bwd_dq_kernel` (:192), launched by `_flash_bwd` (:348).
// Same functions: blocked attention with an online softmax in f32, causal
// masks aligned bottom-right (key j visible to query i iff j <= i + Sk - Sq),
// fully masked key tiles skipped, GQA by kv head = q head / G, masked scores
// set to NEG_INF = -1e30 (never -inf, so exp(s - m) never sees inf - inf),
// a row with l == 0 normalised by 1.  The backward rebuilds
// p = exp(s * scale - lse) and uses delta = rowsum(dO * O) - dlse, which
// the wrapper computes (ray_tpu_torch/ops/attention.py).
//
//   q  [B*Hq,  Sq, D]   k, v [B*Hkv, Sk, D]   f32 or bf16, contiguous
//   o  [B*Hq,  Sq, D]   lse, delta [B*Hq, Sq] f32
//   dq like q, dk/dv like k (the sum over the G query heads of a kv head)
//   D in {64, 128}; Sq, Sk multiples of 64 (the wrapper asks 128);
//   causal needs Sq <= Sk.
//
// Design.  The TPU grid runs its last axis in order and carries the
// softmax state (B1) or the dk/dv/dq sums (B2, B3) across it in VMEM;
// CUDA blocks run in parallel and in no order, so that axis becomes a
// loop inside one block:
//   B1  one block per (q head, 64-query tile), looping over key tiles;
//   B2  one block per (kv head, 64-key tile), looping over the G query
//       heads of the group and, for each, over the query tiles that see
//       the key tile: dk/dv of the whole group stay in registers, so
//       there is no per-q-head [B*Hq, Sk, D] buffer and no atomics;
//   B3  one block per (q head, 64-query tile), looping over key tiles.
// 4 warps per block; each warp owns 16 rows of the block's tile.  Every
// product runs on the tensor cores for bf16 (mma.sync m16n8k16, f32
// accumulate) and as plain f32 FMAs for f32 (no TF32).  Operands are
// staged in shared memory rows padded by 16 bytes (no bank conflicts on
// the fragment loads); p and ds go through shared memory in the input
// type, rounded where the TPU kernels round them (`.astype(dtype)` before
// the dv/dk/o/dq products).  Both types share one accumulator layout,
// that of mma.sync: thread (g = lane/4, t = lane%4) holds, for each
// 8-column tile j, C[g][8j+2t..+1] and C[g+8][8j+2t..+1].
//
// What bounds it on an H100 (llama-1b training shapes: B 4, Hq 32, Hkv 8,
// S 2048, D 64, causal, bf16): B1 does 2 products of 2*S*S/2*D flops per
// head, 6.9e10 flops, ~0.07 ms at 989 TFLOP/s, against 4.2e7 bytes
// (q, k, v, o, lse once) ~0.013 ms at 3.35 TB/s; B2 does 4 such products
// (~0.14 ms) and B3 3 (~0.10 ms), each on ~5e7 bytes.  All three are
// bound by operations.  This first version does not reach that bound:
// it loads tiles synchronously (no cp.async/TMA pipeline), uses mma.sync
// rather than wgmma, and gives causal blocks unequal work.  Making it
// fast is later work; the times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr int kThreads = 128;      // 4 warps x 16 rows = one 64-row tile
constexpr int kTile = 64;

// Padding of a shared-memory row: 16 bytes.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp: C[16 x 8*NT] += A[16 x K] * B[K x 8*NT], all in shared memory.
// A is row-major [m][k] (row stride lda).  B is stored [n][k] (k
// contiguous, B_KN = false) or [k][n] (n contiguous, B_KN = true).
template <int NT, int K, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const __nv_bfloat16* a = A + g * lda + kk + 2 * t;
    const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * lda), a2 = ld32(a + 8),
                   a3 = ld32(a + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b0, b1;
      if (B_KN) {
        const __nv_bfloat16* b = B + (kk + 2 * t) * ldb + 8 * j + g;
        b0 = pack(b[0], b[ldb]);
        b1 = pack(b[8 * ldb], b[9 * ldb]);
      } else {
        const __nv_bfloat16* b = B + (8 * j + g) * ldb + kk + 2 * t;
        b0 = ld32(b);
        b1 = ld32(b + 8);
      }
      mma_bf16(c[j], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int NT, int K, bool B_KN>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* A,
                                         int lda, const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = B_KN ? B[k * ldb + n] : B[n * ldb + k];
      const float b1 = B_KN ? B[k * ldb + n + 1] : B[(n + 1) * ldb + k];
      c[j][0] = fmaf(a_lo, b0, c[j][0]);
      c[j][1] = fmaf(a_lo, b1, c[j][1]);
      c[j][2] = fmaf(a_hi, b0, c[j][2]);
      c[j][3] = fmaf(a_hi, b1, c[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// rows x D elements, global row stride D, into shared memory (stride ld),
// 16 bytes per thread per step.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* src,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(s + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r) * D +
                                        c);
  }
}

// Write a warp's 16 x 8*NT accumulator tile (rows g, g+8) to row-major dst.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* dst, int ld,
                                           const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(dst + g * ld + 8 * j + 2 * t, c[j][0], c[j][1]);
    store2(dst + (g + 8) * ld + 8 * j + 2 * t, c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// B1: forward.  Grid (Sq/64, B*Hq).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int G, float scale,
                 int causal) {
  constexpr int BQ = kTile, BK = kTile;
  constexpr int LD = D + Pad<T>::v, LDP = BK + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + BQ * LD;
  T* v_s = k_s + BK * LD;
  T* p_s = v_s + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int64_t bh = blockIdx.y, bkv = bh / G;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int qpos_lo = offset + q0 + row0 + g, qpos_hi = qpos_lo + 8;

  load_tile<T, D>(q_s, LD, q + (bh * Sq + q0) * D, BQ);
  const T* kg = k + bkv * Sk * D;
  const T* vg = v + bkv * Sk * D;
  int n_kt = Sk / BK;
  if (causal) n_kt = min(n_kt, (offset + q0 + BQ - 1) / BK + 1);

  float acc[D / 8][4];
  zero(acc);
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(k_s, LD, kg + static_cast<int64_t>(kt) * BK * D, BK);
    load_tile<T, D>(v_s, LD, vg + static_cast<int64_t>(kt) * BK * D, BK);
    __syncthreads();
    float s[BK / 8][4];
    zero(s);
    warp_mma<BK / 8, D, false>(s, q_s + row0 * LD, LD, k_s, LD);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt * BK + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && kpos > (e < 2 ? qpos_lo : qpos_hi)) x = kNegInf;
        s[j][e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_lo);
      s[j][1] = expf(s[j][1] - mn_lo);
      s[j][2] = expf(s[j][2] - mn_hi);
      s[j][3] = expf(s[j][3] - mn_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    store_tile<T, BK / 8>(p_s + row0 * LDP, LDP, s);
    l_lo = al_lo * l_lo + quad_sum(sum_lo);
    l_hi = al_hi * l_hi + quad_sum(sum_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al_lo;
      acc[j][1] *= al_lo;
      acc[j][2] *= al_hi;
      acc[j][3] *= al_hi;
    }
    __syncwarp();
    warp_mma<D / 8, BK, true>(acc, p_s + row0 * LDP, LDP, v_s, LD);
  }
  const float L_lo = l_lo == 0.f ? 1.f : l_lo;
  const float L_hi = l_hi == 0.f ? 1.f : l_hi;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] /= L_lo;
    acc[j][1] /= L_lo;
    acc[j][2] /= L_hi;
    acc[j][3] /= L_hi;
  }
  const int64_t r = bh * Sq + q0 + row0;
  store_tile<T, D / 8>(o + r * D, D, acc);
  if (t == 0) {
    lse[r + g] = m_lo + logf(L_lo);
    lse[r + g + 8] = m_hi + logf(L_hi);
  }
}

// ---------------------------------------------------------------------------
// B2: dk, dv.  Grid (Sk/64, B*Hkv); BQ query rows per inner step.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int G, float scale,
                      int causal) {
  constexpr int BK = kTile;
  constexpr int LD = D + Pad<T>::v, LDP = BQ + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BK * LD;
  T* q_s = v_s + BK * LD;
  T* do_s = q_s + BQ * LD;
  T* p_s = do_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(p_s + BK * LDP);
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int64_t bkv = blockIdx.y;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int kpos_lo = k0 + row0 + g, kpos_hi = kpos_lo + 8;

  load_tile<T, D>(k_s, LD, k + (bkv * Sk + k0) * D, BK);
  load_tile<T, D>(v_s, LD, v + (bkv * Sk + k0) * D, BK);
  // First query tile that sees this key tile; none when it is >= Sq/BQ,
  // and then dk = dv = 0.
  const int qt_first = (causal && k0 - offset > 0) ? (k0 - offset) / BQ : 0;
  const int n_qt = Sq / BQ;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int gi = 0; gi < G; ++gi) {
    const int64_t bh = bkv * G + gi;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, D>(q_s, LD, q + (bh * Sq + q0) * D, BQ);
      load_tile<T, D>(do_s, LD, dout + (bh * Sq + q0) * D, BQ);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = lse[bh * Sq + q0 + threadIdx.x];
        dl_s[threadIdx.x] = delta[bh * Sq + q0 + threadIdx.x];
      }
      __syncthreads();
      // s^T = k q^T (keys x queries), then p^T = exp(s^T * scale - lse).
      float p[BQ / 8][4];
      zero(p);
      warp_mma<BQ / 8, D, false>(p, k_s + row0 * LD, LD, q_s, LD);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float x = p[j][e] * scale;
          if (causal && (e < 2 ? kpos_lo : kpos_hi) > offset + q0 + qc)
            x = kNegInf;
          p[j][e] = expf(x - lse_s[qc]);
        }
      }
      store_tile<T, BQ / 8>(p_s + row0 * LDP, LDP, p);
      __syncwarp();
      // dv += p^T dO
      warp_mma<D / 8, BQ, true>(dv_acc, p_s + row0 * LDP, LDP, do_s, LD);
      // dp^T = v dO^T
      float dp[BQ / 8][4];
      zero(dp);
      warp_mma<BQ / 8, D, false>(dp, v_s + row0 * LD, LD, do_s, LD);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          dp[j][e] = p[j][e] * (dp[j][e] - dl_s[qc]) * scale;
        }
      }
      store_tile<T, BQ / 8>(p_s + row0 * LDP, LDP, dp);
      __syncwarp();
      // dk += ds^T q
      warp_mma<D / 8, BQ, true>(dk_acc, p_s + row0 * LDP, LDP, q_s, LD);
    }
  }
  const int64_t r = bkv * Sk + k0 + row0;
  store_tile<T, D / 8>(dk + r * D, D, dk_acc);
  store_tile<T, D / 8>(dv + r * D, D, dv_acc);
}

// ---------------------------------------------------------------------------
// B3: dq.  Grid (Sq/64, B*Hq); BK key rows per inner step.
// ---------------------------------------------------------------------------
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int G, float scale, int causal) {
  constexpr int BQ = kTile;
  constexpr int LD = D + Pad<T>::v, LDP = BK + Pad<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * LD;
  T* k_s = do_s + BQ * LD;
  T* v_s = k_s + BK * LD;
  T* ds_s = v_s + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int64_t bh = blockIdx.y, bkv = bh / G;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int64_t r = bh * Sq + q0 + row0;
  const float lse_lo = lse[r + g], lse_hi = lse[r + g + 8];
  const float dl_lo = delta[r + g], dl_hi = delta[r + g + 8];
  const int qpos_lo = offset + q0 + row0 + g, qpos_hi = qpos_lo + 8;

  load_tile<T, D>(q_s, LD, q + (bh * Sq + q0) * D, BQ);
  load_tile<T, D>(do_s, LD, dout + (bh * Sq + q0) * D, BQ);
  const T* kg = k + bkv * Sk * D;
  const T* vg = v + bkv * Sk * D;
  int n_kt = Sk / BK;
  if (causal) n_kt = min(n_kt, (offset + q0 + BQ - 1) / BK + 1);

  float acc[D / 8][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(k_s, LD, kg + static_cast<int64_t>(kt) * BK * D, BK);
    load_tile<T, D>(v_s, LD, vg + static_cast<int64_t>(kt) * BK * D, BK);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    warp_mma<BK / 8, D, false>(s, q_s + row0 * LD, LD, k_s, LD);    // q k^T
    warp_mma<BK / 8, D, false>(dp, do_s + row0 * LD, LD, v_s, LD);  // dO v^T
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int kpos = kt * BK + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && kpos > (lo ? qpos_lo : qpos_hi)) x = kNegInf;
        const float p = expf(x - (lo ? lse_lo : lse_hi));
        s[j][e] = p * (dp[j][e] - (lo ? dl_lo : dl_hi)) * scale;
      }
    }
    store_tile<T, BK / 8>(ds_s + row0 * LDP, LDP, s);
    __syncwarp();
    // dq += ds k
    warp_mma<D / 8, BK, true>(acc, ds_s + row0 * LDP, LDP, k_s, LD);
  }
  store_tile<T, D / 8>(dq + r * D, D, acc);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int BH, int G, int Sq, int Sk, float scale,
                int causal, cudaStream_t stream) {
  constexpr int LD = D + Pad<T>::v, LDP = kTile + Pad<T>::v;
  constexpr int smem = (3 * kTile * LD + kTile * LDP) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(Sq / kTile, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, G, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int BHkv, int G, int Sq, int Sk,
                     float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = D == 128 ? 32 : 64;  // keeps 4 accumulators in regs
  constexpr int LD = D + Pad<T>::v, LDP = BQ + Pad<T>::v;
  constexpr int smem = (2 * kTile * LD + 2 * BQ * LD + kTile * LDP) *
                           sizeof(T) + 2 * BQ * sizeof(float);
  if (Sq % BQ) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D, BQ>
      <<<dim3(Sk / kTile, BHkv), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, G, scale,
          causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int BH, int G, int Sq, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int BK = D == 128 ? 32 : 64;
  constexpr int LD = D + Pad<T>::v, LDP = BK + Pad<T>::v;
  constexpr int smem =
      (2 * kTile * LD + 2 * BK * LD + kTile * LDP) * sizeof(T);
  if (Sk % BK) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, BK>
      <<<dim3(Sq / kTile, BH), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), Sq, Sk, G, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int BH, int G, int Sq, int Sk, int D, int causal) {
  return BH < 0 || G < 1 || Sq < kTile || Sk < kTile || Sq % kTile ||
         Sk % kTile || (D != 64 && D != 128) || (causal && Sq > Sk);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch (0 = success); each launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int BH, int G, int Sq,
                             int Sk, int D, float scale, int causal,
                             int dtype, void* stream) {
  if (bad_shape(BH, G, Sq, Sk, D, causal) || BH % G)
    return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? fwd<float, 64>(q, k, v, o, lse, BH, G, Sq, Sk, scale,
                                    causal, s)
                   : fwd<float, 128>(q, k, v, o, lse, BH, G, Sq, Sk, scale,
                                     causal, s);
  if (dtype == 1)
    return D == 64 ? fwd<__nv_bfloat16, 64>(q, k, v, o, lse, BH, G, Sq, Sk,
                                            scale, causal, s)
                   : fwd<__nv_bfloat16, 128>(q, k, v, o, lse, BH, G, Sq, Sk,
                                             scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int rtt_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int BHkv, int G,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, int dtype, void* stream) {
  if (bad_shape(BHkv, G, Sq, Sk, D, causal)) return cudaErrorInvalidValue;
  if (BHkv == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? bwd_dkdv<float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         BHkv, G, Sq, Sk, scale, causal, s)
                   : bwd_dkdv<float, 128>(q, k, v, dout, lse, delta, dk, dv,
                                          BHkv, G, Sq, Sk, scale, causal, s);
  if (dtype == 1)
    return D == 64
               ? bwd_dkdv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk,
                                             dv, BHkv, G, Sq, Sk, scale,
                                             causal, s)
               : bwd_dkdv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk,
                                              dv, BHkv, G, Sq, Sk, scale,
                                              causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int BH, int G,
                                int Sq, int Sk, int D, float scale,
                                int causal, int dtype, void* stream) {
  if (bad_shape(BH, G, Sq, Sk, D, causal) || BH % G)
    return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? bwd_dq<float, 64>(q, k, v, dout, lse, delta, dq, BH, G,
                                       Sq, Sk, scale, causal, s)
                   : bwd_dq<float, 128>(q, k, v, dout, lse, delta, dq, BH, G,
                                        Sq, Sk, scale, causal, s);
  if (dtype == 1)
    return D == 64 ? bwd_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                               BH, G, Sq, Sk, scale, causal,
                                               s)
                   : bwd_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                dq, BH, G, Sq, Sk, scale,
                                                causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
