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
//   D in {64, 128}; Sq, Sk multiples of 64 (in bf16: of 128; the
//   wrapper asks 128 everywhere);
//   causal needs Sq <= Sk.
//
// Design.  The TPU grid runs its last axis in order and carries the
// softmax state (B1) or the dk/dv/dq sums (B2, B3) across it in VMEM;
// CUDA blocks run in parallel and in no order, so that axis becomes a
// loop inside one block.
//
// B1, bf16 (`flash_fwd_wgmma_kernel`), built for Hopper:
//   * work tiles of (q head, 64 queries per consumer warpgroup); a
//     persistent grid, one block per SM, walks them heaviest (last query
//     tile) first, the G query heads of a kv head next to each other so
//     that their K and V tiles are hits in L2; the next tile's loads
//     overlap this one's epilogue; a last tile past Sq is not stored;
//   * a block is three consumer warpgroups at D 64 (192-row tiles, 512
//     threads) or two at D 128 (128 rows, 384 threads), and one producer
//     warpgroup; setmaxnreg moves registers from the producer (24) to
//     the consumers (160 at D 64, 240 at D 128);
//   * the producer's one thread loads each tile's Q and keeps a 2-stage
//     ring of 128-key K and V tiles in flight with TMA (tensor maps built
//     on the host, passed as __grid_constant__), completion on mbarriers
//     (full: transaction bytes; empty: one arrival per consumer warp; K
//     and V stages released separately); boxes of 128 rows x 64 columns
//     are one 128-byte swizzle span wide, so D 64 is one box per tile and
//     D 128 two;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K in its natural [keys, D] layout is the K-major B operand);
//   * O += P V is wgmma with P as the register A operand (the S
//     accumulators rounded to bf16, as the TPU kernel rounds p) and V
//     [keys, D] as the MN-major B operand (transpose bit): p never goes
//     through shared memory;
//   * the online softmax runs in registers with exp2 (scale * log2 e
//     folded in), lse goes back to natural log on the store; the causal
//     compare runs only on a tile that crosses the diagonal (key tiles
//     run from the last, diagonal, one down);
//   * the exponentials (16 a cycle an SM) take about as long as the
//     products at D 64, so they are hidden behind tensor-core work: a
//     warpgroup issues S of key tile i with P V of tile i-1, waits for S
//     only and runs its softmax while P V runs, and the two warpgroups
//     take turns issuing (named barriers 1 and 2).
// B2, bf16 (`flash_bwd_dkdv_wgmma_kernel`), the same design carried to
// the backward in the TPU kernel's transposed form (keys x queries):
//   * work tiles of (kv head, 128 keys), one consumer warpgroup per 64
//     keys; a persistent grid walks them lowest key block first (under a
//     causal mask the heaviest), in rounds of alternating direction, so
//     that every block gets about the same number of steps;
//   * K and V of a work tile are loaded once; the producer keeps a
//     3-stage ring of (Q, dO, lse, delta) tiles over the G query heads of
//     the kv head and the query tiles that see the key block (TMA boxes
//     for Q and dO, 1-D bulk copies for lse and delta);
//   * S^T = K Q^T and dP^T = V dO^T are SS wgmma (K, V the A operand,
//     Q and dO in their natural [queries, D] layout the K-major B);
//     P^T = exp2(S^T * scale * log2 e - lse * log2 e) and
//     dS^T = P^T (dP^T - delta) scale in registers; dV += P^T dO and
//     dK += dS^T Q are wgmma with P^T and dS^T rounded to bf16 as the
//     register A operand (as the TPU kernel rounds them) and dO, Q the
//     MN-major B: p and ds never go through shared memory, and one Q and
//     one dO tile serve both orientations;
//   * the G query heads' dK and dV stay in f32 registers and are rounded
//     once on the store: no atomics, the same bits from call to call;
//   * 128 queries a tile at D 64 (S^T, dP^T 64 registers each, dK, dV 32)
//     and 64 at D 128 (32 each, dK, dV 64); the exponentials of one
//     warpgroup run while the other's products are on the tensor cores,
//     and dP^T's product while its own exponentials run.
// B3, bf16 (`flash_bwd_dq_wgmma_kernel`), B1's structure with one product
// more: work tiles of (q head, 128 queries), two consumer warpgroups of
// 64 query rows, heaviest (last) query tiles first; the producer streams
// K and V tiles of 128 keys at D 64 (64 at D 128, where S, dP and dQ
// take 32, 32 and 64 registers) through a 3-stage ring, K and V stages
// released separately (a K stage is held until the next turn's dQ is
// done), and loads the next work tile's Q and dO into a second slot
// while this one's run; S = Q K^T and dP = dO V^T are SS wgmma, dS in
// registers, dQ += dS K with dS as the register A operand and K the
// MN-major B.  Each turn issues S and dP of key tile i with dQ of tile
// i-1, waits for S alone and runs the exponentials while the other two
// products run; the two warpgroups take turns issuing (named barriers).
// B1, f32 (`flash_fwd_kernel`), B2 and B3 in f32: 4 warps per block, each
// warp owns 16 rows of the block's 64-row tile:
//   B1  one block per (q head, 64-query tile), looping over key tiles;
//   B2  one block per (kv head, 64-key tile), looping over the G query
//       heads of the group and, for each, over the query tiles that see
//       the key tile: dk/dv of the whole group stay in registers, so
//       there is no per-q-head [B*Hq, Sk, D] buffer and no atomics;
//   B3  one block per (q head, 64-query tile), looping over key tiles.
// Their products are plain FMAs (no TF32): wgmma has no f32 form, only
// TF32, whose 10-bit mantissa would break the 1e-5 limits of the f32
// checks and the f32 trainer's step-for-step agreement with the plain
// one.  Operands are staged in shared memory rows padded by 16 bytes; p
// and ds go through shared memory.  The accumulator layout is that of
// mma.sync (and of each warp's quarter of a wgmma accumulator): thread
// (g = lane/4, t = lane%4) holds, for each 8-column tile j,
// C[g][8j+2t..+1] and C[g+8][8j+2t..+1].
//
// What bounds it on an H100 (llama-1b training shapes: B 4, Hq 32, Hkv 8,
// S 2048, D 64, causal, bf16): B1 does 2 products of 2*S*S/2*D flops per
// head, 6.9e10 flops, ~0.07 ms at 989 TFLOP/s, against 4.2e7 bytes
// (q, k, v, o, lse once) ~0.013 ms at 3.35 TB/s; B2 does 4 such products
// (~0.14 ms) and B3 3 (~0.10 ms), each on ~5e7 bytes.  All three are
// bound by operations, so the tensor cores' rate is what the design
// chases: wgmma fed by TMA, the exponentials and conversions hidden
// behind the products (times in PERF.md).

#include <cuda.h>
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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
// B1, bf16: TMA + wgmma forward.  Persistent grid (one block per SM);
// FwdCfg<D> consumer warpgroups of 64 query rows and one producer.
// ---------------------------------------------------------------------------
constexpr int kBK = 128;                 // keys per K/V tile
constexpr int kStages = 2;               // K/V ring depth
// Consumer warpgroups of 64 query rows each: three at D 64 (where the
// exponentials weigh most against the products, a third warpgroup keeps
// the tensor cores fed), two at D 128 (whose O accumulator leaves
// registers for no third).  Plus one producer warpgroup.
template <int D>
struct FwdCfg {
  static constexpr int kWG = D == 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kWG;             // query rows per tile
  static constexpr int kWarps = 4 * kWG;           // consumer warps
  static constexpr int kThreads = 128 * kWG + 128;
};
constexpr int kBox = 128 * 128;          // one 128-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  The poll loop
// lives inside the asm, so the compiler sees no divergent branch around
// the wgmma that follow (which it would otherwise serialise).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One TMA box (box coordinates: column c0, row c1) into shared memory,
// completion reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) from global `src` into shared memory, one
// 1-D bulk copy, completion reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of wgmma accumulators across the
// wait (the asm above does not name them).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for the register A operand of a wgmma still running: its
// registers stay untouched until the wait.
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// Shared-memory matrix descriptor, 128-byte swizzle (the layout TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes): start address, leading and stride
// byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (descriptors), f32 accumulators in the wgmma layout.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs in
// the mma.sync A layout), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (bf16 pairs in
// the mma.sync A layout), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, flush to zero
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Named barriers 1 and 2 over the 256 consumer threads (0 is
// __syncthreads'); a warpgroup syncs on its own and arrives on the other.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// C[64 x N] = A[64 x D] B[N x D]^T, both K-major in shared memory
// (128-byte swizzled boxes of 64 columns, a_box and b_box bytes apart):
// k-step kk reads 16 columns (32 bytes inside a 128-byte swizzle row) of
// box kk/4.
template <int N, int D>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2],
                                         const unsigned char* a, int a_box,
                                         const unsigned char* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(a + (kk / 4) * a_box + (kk % 4) * 32, 16,
                                   1024);
    const uint64_t db = desc_sw128(b + (kk / 4) * b_box + (kk % 4) * 32, 16,
                                   1024);
    if constexpr (N == 128) {
      wgmma_ss_n128(c, da, db, kk > 0);
    } else {
      wgmma_ss_n64(c, da, db, kk > 0);
    }
  }
}

// C[64 x D] += A[64 x K] B[K x D]: A in registers (bf16 pairs in the
// mma.sync A layout, one [4] per 16-deep step), B [K rows, D] in shared
// memory as the MN-major operand (transpose bit): 64-column boxes `box`
// bytes apart, 8-row groups 1024 bytes apart.
template <int K, int D>
__device__ __forceinline__ void issue_rs_tb(float (&c)[D / 2],
                                            const uint32_t (&a)[K / 16][4],
                                            const unsigned char* b,
                                            int box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * 128, box, 1024);
    if constexpr (D == 64) {
      wgmma_rs_n64_tb(c, a[kk], db);
    } else {
      wgmma_rs_n128_tb(c, a[kk], db);
    }
  }
}

// A [64 x K] accumulator rounded to bf16 as the register A operand of the
// next product (the mma.sync A layout: k-step kk takes 8-column blocks
// 2kk and 2kk+1).
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K / 16][4],
                                       const float (&c)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The n-th work tile of block b in a persistent grid of `grid` blocks,
// rounds in alternating direction: with tiles ordered heaviest first, a
// block that takes one of the heaviest tiles of a round takes one of the
// lightest of the next.  Past the last tile once it is >= the count.
__device__ __forceinline__ int snake_tile(int n, int b, int grid) {
  return n * grid + ((n & 1) ? grid - 1 - b : b);
}

// Work tile `tile` of the persistent forward: the heaviest (last) query
// tiles come first, and the G query heads of a kv head sit next to each
// other, so that their K/V tiles are hits in L2.
// A last tile that runs past Sq loads rows it does not store.
template <int BQ>
struct FwdTile {
  int bh, q0, n_kt;
  __device__ FwdTile(int tile, int BH, int Sq, int Sk, int causal) {
    bh = tile % BH;
    q0 = ((Sq + BQ - 1) / BQ - 1 - tile / BH) * BQ;
    n_kt = Sk / kBK;
    if (causal) n_kt = min(n_kt, (Sk - Sq + q0 + BQ - 1) / kBK + 1);
  }
};

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int BH, int Sq, int Sk,
                       int G, float scale, int causal) {
  constexpr int NC = FwdCfg<D>::kWG, kBQ = FwdCfg<D>::kBQ;
  constexpr int kConsumerWarps = FwdCfg<D>::kWarps;
  constexpr int kQBox = kBQ * 128;         // kBQ rows x 64 columns, bf16
  constexpr int kTile = (D / 64) * kBox;   // 128 key rows x D, bf16
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries (the swizzle atom).
  unsigned char* q_s =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* k_s = q_s + (D / 64) * kQBox;      // [kStages][kTile]
  unsigned char* v_s = k_s + kStages * kTile;       // [kStages][kTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;                   // [kStages] each
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int n_tiles = (Sq + kBQ - 1) / kBQ * BH;
  const int offset = Sk - Sq;
  // Broadcast, so that the compiler knows the warp index is uniform in a
  // warp and the role branches below are not divergent.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each block walks tiles blockIdx.x, + gridDim.x, ...; the K/V ring's
  // stage and phase run on across tiles (`kv` counts the ring's tiles).
  if (warp >= kConsumerWarps) {
    // Producer warpgroup: gives most of its registers to the consumers
    // (24 here; 160 or 240 there, from the block's 128 or 168).  One
    // thread loads each work tile's Q once both consumer warpgroups are
    // done with the previous one, then its K/V tiles into the ring, last
    // key tile first (the diagonal one under a causal mask); a K stage is
    // refilled once both consumer warpgroups' Q K^T on it finished, a V
    // stage once their P V did.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int kv = 0, nt = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++nt) {
        const FwdTile<kBQ> w(tile, BH, Sq, Sk, causal);
        if (nt > 0) mbar_wait(q_empty, (nt - 1) & 1);
        mbar_expect_tx(q_full, (D / 64) * kQBox);
        for (int c = 0; c < D / 64; ++c)
          tma_load(q_s + c * kQBox, &tm_q, c * 64, w.bh * Sq + w.q0,
                   q_full);
        const int kv_row0 = (w.bh / G) * Sk;
        for (int it = 0; it < w.n_kt; ++it, ++kv) {
          const int s = kv % kStages;
          const uint32_t parity = (kv / kStages - 1) & 1;
          const int row = kv_row0 + (w.n_kt - 1 - it) * kBK;
          if (kv >= kStages) mbar_wait(&k_empty[s], parity);
          mbar_expect_tx(&k_full[s], kTile);
          for (int c = 0; c < D / 64; ++c)
            tma_load(k_s + s * kTile + c * kBox, &tm_k, c * 64, row,
                     &k_full[s]);
          if (kv >= kStages) mbar_wait(&v_empty[s], parity);
          mbar_expect_tx(&v_full[s], kTile);
          for (int c = 0; c < D / 64; ++c)
            tma_load(v_s + s * kTile + c * kBox, &tm_v, c * 64, row,
                     &v_full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64*wg .. +63 of a work
  // tile; in the accumulator layout thread (g, t) of warp wl holds rows
  // 16*wl + g and +8, columns 8j + 2t, +1 of each 8-column block j.
  //
  // Each turn issues S = Q K^T of key tile it and O += P V of key tile
  // it-1 (P in registers), waits for S only, and runs the softmax of tile
  // it while P V is still on the tensor cores.  The two warpgroups take
  // turns issuing (named barriers 1 and 2), so one's products run while
  // the other computes exponentials.
  if constexpr (NC == 3) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  }
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const unsigned char* q_wg = q_s + wg * 64 * 128;
  float acc[D / 2];
  float sc[64];                          // S, then p, of the newest tile
  uint32_t pa[kBK / 16][4];              // p of the tile before, bf16
  // Running max of the raw scores, and this thread's share of the row
  // sums (reduced over the quad at the end).
  float m_lo, m_hi, l_lo, l_hi;
  float al_lo, al_hi;                    // rescale of O for the newest tile
  int n_kt = 0, q0 = 0, qpos_lo = 0, qpos_hi = 0;

  // Online softmax of key tile `it` in registers on the raw scores:
  // p = exp2(s * scale * log2 e - m * scale * log2 e), one FFMA and one
  // ex2 per element, left in sc; the causal compare only on a tile that
  // crosses the diagonal.
  auto softmax = [&](int it) {
    const int k0 = (n_kt - 1 - it) * kBK;
    if (causal && k0 + kBK - 1 > offset + q0 + wg * 64) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) > (e < 2 ? qpos_lo : qpos_hi))
            sc[4 * j + e] = kNegInf;
    }
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    al_lo = ex2((m_lo - mn_lo) * scale_log2);
    al_hi = ex2((m_hi - mn_hi) * scale_log2);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // A row that has seen only masked keys so far (a 192-row tile's
    // warpgroup can meet a key tile wholly above its diagonal) keeps
    // m = NEG_INF; a zero bias then gives its masked scores p = 0, where
    // fmaf(NEG_INF, c, -NEG_INF * c) would leave the unrounded product's
    // error and overflow.  Its later alpha is 0 either way.
    const float nb_lo = mn_lo == kNegInf ? 0.f : -mn_lo * scale_log2;
    const float nb_hi = mn_hi == kNegInf ? 0.f : -mn_hi * scale_log2;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, nb_lo));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, nb_lo));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, nb_hi));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, nb_hi));
      sum_lo += sc[4 * j] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
  };
  // O *= alpha, and p rounded to bf16 as the register A operand of P V.
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= al_lo;
      acc[4 * j + 1] *= al_lo;
      acc[4 * j + 2] *= al_hi;
      acc[4 * j + 3] *= al_hi;
    }
    pack_a<kBK>(pa, sc);
  };
  // O += P V: V [keys, D] is the MN-major B operand.
  auto issue_pv = [&](const unsigned char* v_tile) {
    issue_rs_tb<kBK, D>(acc, pa, v_tile, kBox);
  };
  // Q is released once this warp's last Q K^T of the work tile is done.
  auto release = [&](int it, int s) {
    if (lane == 0) {
      mbar_arrive(&k_empty[s]);
      if (it == n_kt - 1) mbar_arrive(q_empty);
    }
  };

  int kv = 0, nt = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++nt) {
    const FwdTile<kBQ> w(tile, BH, Sq, Sk, causal);
    n_kt = w.n_kt;
    q0 = w.q0;
    const int row_lo = q0 + wg * 64 + wl * 16 + g;
    qpos_lo = offset + row_lo;
    qpos_hi = qpos_lo + 8;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m_lo = m_hi = kNegInf;
    l_lo = l_hi = 0.f;

    // First turn: S of key tile 0.
    mbar_wait(q_full, nt & 1);
    mbar_wait(&k_full[kv % kStages], (kv / kStages) & 1);
    if (wg == NC - 1) named_arrive(1);   // warpgroup 0 goes first
    named_sync(1 + wg);
    wgmma_fence();
    issue_ss<kBK, D>(sc, q_wg, kQBox, k_s + kv % kStages * kTile, kBox);
    wgmma_commit();
    named_arrive(1 + (wg + 1) % NC);
    wgmma_wait<0>();
    reg_fence(sc);
    release(0, kv % kStages);
    softmax(0);
    rescale_and_pack();

    for (int it = 1; it < n_kt; ++it) {
      const int s = (kv + it) % kStages, sp = (kv + it - 1) % kStages;
      mbar_wait(&k_full[s], ((kv + it) / kStages) & 1);
      mbar_wait(&v_full[sp], ((kv + it - 1) / kStages) & 1);
      named_sync(1 + wg);
      wgmma_fence();
      issue_ss<kBK, D>(sc, q_wg, kQBox, k_s + s * kTile, kBox);
      wgmma_commit();
      issue_pv(v_s + sp * kTile);
      wgmma_commit();
      named_arrive(1 + (wg + 1) % NC);
      wgmma_wait<1>();                   // S done; P V may still run
      reg_fence(sc);
      release(it, s);
      softmax(it);
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&v_empty[sp]);
      rescale_and_pack();
    }

    // Last turn: P V of the last key tile.  The last warpgroup gives no
    // turn back, so the arrivals on each barrier match its waits.
    const int sl = (kv + n_kt - 1) % kStages;
    mbar_wait(&v_full[sl], ((kv + n_kt - 1) / kStages) & 1);
    named_sync(1 + wg);
    wgmma_fence();
    issue_pv(v_s + sl * kTile);
    wgmma_commit();
    if (wg != NC - 1) named_arrive(1 + (wg + 1) % NC);
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(&v_empty[sl]);
    kv += n_kt;

    const float L_lo0 = quad_sum(l_lo), L_hi0 = quad_sum(l_hi);
    const float L_lo = L_lo0 == 0.f ? 1.f : L_lo0;
    const float L_hi = L_hi0 == 0.f ? 1.f : L_hi0;
    const float inv_lo = 1.f / L_lo, inv_hi = 1.f / L_hi;
    const int64_t r = static_cast<int64_t>(w.bh) * Sq + row_lo;
    __nv_bfloat16* o_lo = o + r * D + 2 * t;
    __nv_bfloat16* o_hi = o_lo + 8 * D;
    if (row_lo < Sq) {                   // rows past Sq are not stored
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(o_lo + 8 * j, acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
      if (t == 0) lse[r] = m_lo * scale + logf(L_lo);   // natural log
    }
    if (row_lo + 8 < Sq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(o_hi + 8 * j, acc[4 * j + 2] * inv_hi,
               acc[4 * j + 3] * inv_hi);
      if (t == 0) lse[r + 8] = m_hi * scale + logf(L_hi);
    }
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
// Backward in bf16: TMA + wgmma, persistent grids, two consumer warpgroups
// and one producer warpgroup per block.
// ---------------------------------------------------------------------------
// Ring depth of the streamed tiles, and B3's slots for (Q, dO): a
// second slot loads the next work tile's while this one's run (both
// shortened B3 in an A/B on the card; B2 ran the same either way).
constexpr int kBwdStages = 3;
constexpr int kQSlots = 2;
constexpr int kBwdWarps = 8;            // consumer warps (two warpgroups)
constexpr int kBwdThreads = 384;        // and one producer warpgroup

// B2: a work tile is 128 keys of one kv head (64 per consumer warpgroup);
// kBQ queries per streamed (Q, dO, lse, delta) tile.
template <int D>
struct DkdvCfg {
  static constexpr int kBQ = D == 64 ? 128 : 64;
  static constexpr int kKTile = (D / 64) * kBox;   // 128 keys x D, bf16
  static constexpr int kQBox = kBQ * 128;          // kBQ rows x 64 columns
  static constexpr int kQTile = (D / 64) * kQBox;
  static constexpr int kStage = 2 * kQTile + 2 * kBQ * 4;
  static constexpr int kSmem =
      1024 + 2 * kKTile + kBwdStages * kStage + (2 + 2 * kBwdStages) * 8;
};

// Work tile `tile` of the dk/dv kernel: kv head bkv, keys k0 .. k0+127,
// lowest key blocks first (under a causal mask they see the most query
// tiles), the kv heads of a key block next to each other.  It runs
// n_iter = G * (n_qt - qt_first) steps: the G query heads, each over the
// query tiles from the first that sees the key block.
template <int BQ>
struct DkdvTile {
  int bkv, k0, qt_first, n_qt, n_iter;
  __device__ DkdvTile(int tile, int BHkv, int Sq, int Sk, int G,
                      int causal) {
    bkv = tile % BHkv;
    k0 = tile / BHkv * 128;
    n_qt = Sq / BQ;
    qt_first = causal && k0 > Sk - Sq ? (k0 - (Sk - Sq)) / BQ : 0;
    n_iter = G * max(n_qt - qt_first, 0);
  }
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int BHkv,
                            int Sq, int Sk, int G, float scale, int causal) {
  using C = DkdvCfg<D>;
  constexpr int BQ = C::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* v_s = k_s + C::kKTile;
  unsigned char* q_s = v_s + C::kKTile;              // [kBwdStages][kQTile]
  unsigned char* do_s = q_s + kBwdStages * C::kQTile;
  float* lse_s = reinterpret_cast<float*>(do_s + kBwdStages * C::kQTile);
  float* dl_s = lse_s + kBwdStages * BQ;             // [kBwdStages][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kBwdStages * BQ);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;                     // [kBwdStages] each
  uint64_t* empty = full + kBwdStages;

  const int n_tiles = BHkv * (Sk / 128);
  const int offset = Sk - Sq;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kBwdWarps);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBwdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each block walks its work tiles in snake order; the stage ring's
  // count `c` and the K/V count `nkv` run on across tiles.
  if (warp >= kBwdWarps) {
    // Producer: one thread loads each step's (Q, dO, lse, delta) into the
    // ring, and the work tile's K and V once both consumer warpgroups are
    // done with the last tile's (after the tile's first step, so that one
    // step is in flight across the boundary).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kBwdWarps && lane == 0) {
      int c = 0, nkv = 0;
      for (int n = 0;; ++n) {
        const int tile = snake_tile(n, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const DkdvTile<BQ> w(tile, BHkv, Sq, Sk, G, causal);
        if (w.n_iter == 0) continue;
        const int per_head = w.n_qt - w.qt_first;
        for (int i = 0; i < w.n_iter; ++i, ++c) {
          const int s = c % kBwdStages;
          if (c >= kBwdStages)
            mbar_wait(&empty[s], (c / kBwdStages - 1) & 1);
          mbar_expect_tx(&full[s], C::kStage);
          const int row = (w.bkv * G + i / per_head) * Sq +
                          (w.qt_first + i % per_head) * BQ;
          for (int b = 0; b < D / 64; ++b) {
            tma_load(q_s + s * C::kQTile + b * C::kQBox, &tm_q, b * 64, row,
                     &full[s]);
            tma_load(do_s + s * C::kQTile + b * C::kQBox, &tm_do, b * 64,
                     row, &full[s]);
          }
          bulk_load(lse_s + s * BQ, lse + row, BQ * 4, &full[s]);
          bulk_load(dl_s + s * BQ, delta + row, BQ * 4, &full[s]);
          if (i == 0) {
            if (nkv > 0) mbar_wait(kv_empty, (nkv - 1) & 1);
            mbar_expect_tx(kv_full, 2 * C::kKTile);
            for (int b = 0; b < D / 64; ++b) {
              tma_load(k_s + b * kBox, &tm_k, b * 64, w.bkv * Sk + w.k0,
                       kv_full);
              tma_load(v_s + b * kBox, &tm_v, b * 64, w.bkv * Sk + w.k0,
                       kv_full);
            }
            ++nkv;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys k0 + 64*wg .. +63 of a work tile; in
  // the accumulator layout thread (g, t) of warp wl holds key rows
  // 16*wl + g and +8, query columns 8j + 2t, +1 of each 8-column block j.
  // Each step: S^T and dP^T issued together; P^T while dP^T runs; dS^T;
  // then dV and dK, waited for before the next step (their A operands
  // and the next step's S^T, dP^T would not fit in registers together;
  // the other warpgroup's work fills the tensor cores meanwhile).  Steps
  // of 64 queries pipelined across that wait (K and V in registers, FA3's
  // order) and named-barrier turns were both slower in A/Bs on the card.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const unsigned char* k_wg = k_s + wg * 64 * 128;
  const unsigned char* v_wg = v_s + wg * 64 * 128;
  float dk_acc[D / 2], dv_acc[D / 2];

  int c = 0, nkv = 0;
  for (int n = 0;; ++n) {
    const int tile = snake_tile(n, blockIdx.x, gridDim.x);
    if (tile >= n_tiles) break;
    const DkdvTile<BQ> w(tile, BHkv, Sq, Sk, G, causal);
    const int kw0 = w.k0 + wg * 64;
    const int key_lo = kw0 + wl * 16 + g, key_hi = key_lo + 8;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    if (w.n_iter > 0) {
      mbar_wait(kv_full, nkv & 1);
      const int per_head = w.n_qt - w.qt_first;
      for (int i = 0; i < w.n_iter; ++i, ++c) {
        const int s = c % kBwdStages;
        const unsigned char* q_t = q_s + s * C::kQTile;
        const unsigned char* do_t = do_s + s * C::kQTile;
        const float* lse_t = lse_s + s * BQ;
        const float* dl_t = dl_s + s * BQ;
        const int q0 = (w.qt_first + i % per_head) * BQ;
        // Declared per step: the products write them from scratch, so
        // nothing of the last step stays live across the issue.
        float sc[BQ / 2], dp[BQ / 2];    // S^T then P^T; dP^T then dS^T
        uint32_t pa[BQ / 16][4], pb[BQ / 16][4];   // P^T, dS^T in bf16
        mbar_wait(&full[s], (c / kBwdStages) & 1);
        wgmma_fence();
        issue_ss<BQ, D>(sc, k_wg, kBox, q_t, C::kQBox);    // S^T = K Q^T
        wgmma_commit();
        issue_ss<BQ, D>(dp, v_wg, kBox, do_t, C::kQBox);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(sc);
        // P^T = exp(S^T scale - lse): one FFMA and one ex2 an element; the
        // causal compare (key > query + offset) only on a tile that
        // crosses the diagonal.
        if (causal && kw0 + 63 > q0 + offset) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((e < 2 ? key_lo : key_hi) >
                  q0 + 8 * j + 2 * t + (e & 1) + offset)
                sc[4 * j + e] = kNegInf;
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l =
              *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
          const float nl0 = -l.x * kLog2e, nl1 = -l.y * kLog2e;
          sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, nl0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, nl1));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, nl0));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, nl1));
        }
        wgmma_wait<0>();
        reg_fence(dp);
        // dS^T = P^T (dP^T - delta) scale, in f32 from the f32 P^T, as
        // P^T (dP^T scale - delta scale): one FFMA and one FMUL an element.
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 d =
              *reinterpret_cast<const float2*>(dl_t + 8 * j + 2 * t);
          const float nd0 = -d.x * scale, nd1 = -d.y * scale;
          dp[4 * j] = sc[4 * j] * fmaf(dp[4 * j], scale, nd0);
          dp[4 * j + 1] = sc[4 * j + 1] * fmaf(dp[4 * j + 1], scale, nd1);
          dp[4 * j + 2] = sc[4 * j + 2] * fmaf(dp[4 * j + 2], scale, nd0);
          dp[4 * j + 3] = sc[4 * j + 3] * fmaf(dp[4 * j + 3], scale, nd1);
        }
        pack_a<BQ>(pa, sc);
        pack_a<BQ>(pb, dp);
        wgmma_fence();
        issue_rs_tb<BQ, D>(dv_acc, pa, do_t, C::kQBox);   // dV += P^T dO
        issue_rs_tb<BQ, D>(dk_acc, pb, q_t, C::kQBox);    // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        reg_fence(pa);
        reg_fence(pb);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (lane == 0) mbar_arrive(kv_empty);
      ++nkv;
    }
    // dK and dV of the whole group, rounded once.
    const int64_t r = static_cast<int64_t>(w.bkv) * Sk + key_lo;
    __nv_bfloat16* dk_lo = dk + r * D + 2 * t;
    __nv_bfloat16* dv_lo = dv + r * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk_lo + 8 * j, dk_acc[4 * j], dk_acc[4 * j + 1]);
      store2(dk_lo + 8 * D + 8 * j, dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      store2(dv_lo + 8 * j, dv_acc[4 * j], dv_acc[4 * j + 1]);
      store2(dv_lo + 8 * D + 8 * j, dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// B3: a work tile is 128 query rows of one q head (64 per consumer
// warpgroup); kBK keys per streamed K or V tile.
template <int D>
struct DqCfg {
  static constexpr int kBK = D == 64 ? 128 : 64;
  static constexpr int kQTile = (D / 64) * kBox;   // 128 rows x D, bf16
  static constexpr int kKBox = kBK * 128;          // kBK rows x 64 columns
  static constexpr int kKTile = (D / 64) * kKBox;
  static constexpr int kSmem = 1024 + kQSlots * 2 * kQTile +
                               2 * kBwdStages * kKTile +
                               (2 * kQSlots + 4 * kBwdStages) * 8;
};

// Work tile `tile` of the dq kernel: the heaviest (last) query tiles
// first, the G query heads of a kv head next to each other (their K/V
// tiles are hits in L2); n_kt key tiles of BK keys see it.
template <int BK>
struct DqTile {
  int bh, q0, n_kt;
  __device__ DqTile(int tile, int BH, int Sq, int Sk, int causal) {
    bh = tile % BH;
    q0 = (Sq / 128 - 1 - tile / BH) * 128;
    n_kt = Sk / BK;
    if (causal) n_kt = min(n_kt, (Sk - Sq + q0 + 127) / BK + 1);
  }
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int BH, int Sq,
                          int Sk, int G, float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int BK = C::kBK, NC = 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* do_s = q_s + kQSlots * C::kQTile;   // [kQSlots][kQTile]
  unsigned char* k_s = do_s + kQSlots * C::kQTile;   // [kBwdStages][kKTile]
  unsigned char* v_s = k_s + kBwdStages * C::kKTile;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_s + kBwdStages * C::kKTile);
  uint64_t* q_empty = q_full + kQSlots;              // [kQSlots] each
  uint64_t* k_full = q_empty + kQSlots;              // [kBwdStages] each
  uint64_t* v_full = k_full + kBwdStages;
  uint64_t* k_empty = v_full + kBwdStages;
  uint64_t* v_empty = k_empty + kBwdStages;

  const int n_tiles = Sq / 128 * BH;
  const int offset = Sk - Sq;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kBwdWarps);
    }
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kBwdWarps);
      mbar_init(&v_empty[s], kBwdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBwdWarps) {
    // Producer: each work tile's Q and dO once both consumer warpgroups
    // are done with the last tile's, then its K and V tiles into the
    // ring, last key tile (the diagonal one under a causal mask) first; a
    // K stage is refilled once both warpgroups' dQ product on it
    // finished, a V stage once their dP did.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kBwdWarps && lane == 0) {
      int kv = 0, nt = 0;
      for (int n = 0;; ++n, ++nt) {
        const int tile = snake_tile(n, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const DqTile<BK> w(tile, BH, Sq, Sk, causal);
        const int qs = nt % kQSlots;
        if (nt >= kQSlots) mbar_wait(&q_empty[qs], (nt / kQSlots - 1) & 1);
        mbar_expect_tx(&q_full[qs], 2 * C::kQTile);
        for (int b = 0; b < D / 64; ++b) {
          tma_load(q_s + qs * C::kQTile + b * kBox, &tm_q, b * 64,
                   w.bh * Sq + w.q0, &q_full[qs]);
          tma_load(do_s + qs * C::kQTile + b * kBox, &tm_do, b * 64,
                   w.bh * Sq + w.q0, &q_full[qs]);
        }
        const int kv_row0 = (w.bh / G) * Sk;
        for (int it = 0; it < w.n_kt; ++it, ++kv) {
          const int s = kv % kBwdStages;
          const uint32_t parity = (kv / kBwdStages - 1) & 1;
          const int row = kv_row0 + (w.n_kt - 1 - it) * BK;
          if (kv >= kBwdStages) mbar_wait(&k_empty[s], parity);
          mbar_expect_tx(&k_full[s], C::kKTile);
          for (int b = 0; b < D / 64; ++b)
            tma_load(k_s + s * C::kKTile + b * C::kKBox, &tm_k, b * 64, row,
                     &k_full[s]);
          if (kv >= kBwdStages) mbar_wait(&v_empty[s], parity);
          mbar_expect_tx(&v_full[s], C::kKTile);
          for (int b = 0; b < D / 64; ++b)
            tma_load(v_s + s * C::kKTile + b * C::kKBox, &tm_v, b * 64, row,
                     &v_full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64*wg .. +63; thread
  // (g, t) of warp wl holds rows 16*wl + g and +8, key columns 8j + 2t, +1.
  // Each turn issues S and dP of key tile it with dQ += dS K of tile it-1
  // (dS in registers), waits for S alone, runs the exponentials while dP
  // and dQ run, then dS.  The two warpgroups take turns issuing (named
  // barriers 1 and 2).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const unsigned char* q_wg = q_s + wg * 64 * 128;    // in slot qs
  const unsigned char* do_wg = do_s + wg * 64 * 128;
  int qs = 0;
  float acc[D / 2];
  float sc[BK / 2], dp[BK / 2];          // S then P then dS; dP
  uint32_t pa[BK / 16][4];               // dS of the tile before, bf16
  int n_kt = 0, q0 = 0, qpos_lo = 0;
  float nl_lo = 0.f, nl_hi = 0.f, nd_lo = 0.f, nd_hi = 0.f;  // -lse, -delta

  // P = exp(S scale - lse) of key tile `it`; the causal compare only on a
  // tile that crosses this warpgroup's diagonal.
  auto probs = [&](int it) {
    const int k0 = (n_kt - 1 - it) * BK;
    if (causal && k0 + BK - 1 > offset + q0 + wg * 64) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) > qpos_lo + (e < 2 ? 0 : 8))
            sc[4 * j + e] = kNegInf;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, nl_lo));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, nl_lo));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, nl_hi));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, nl_hi));
    }
  };
  // dS = P (dP - delta) scale, in f32, into sc, as P (dP scale - delta
  // scale): one FFMA and one FMUL an element (shorter on the card than
  // three operations).
  auto dscores = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = sc[4 * j] * fmaf(dp[4 * j], scale, nd_lo);
      sc[4 * j + 1] = sc[4 * j + 1] * fmaf(dp[4 * j + 1], scale, nd_lo);
      sc[4 * j + 2] = sc[4 * j + 2] * fmaf(dp[4 * j + 2], scale, nd_hi);
      sc[4 * j + 3] = sc[4 * j + 3] * fmaf(dp[4 * j + 3], scale, nd_hi);
    }
  };
  // The V stage is free once dP is done; Q and dO once this warp's last
  // S and dP of the work tile are.
  auto release_v = [&](int it, int s) {
    if (lane == 0) {
      mbar_arrive(&v_empty[s]);
      if (it == n_kt - 1) mbar_arrive(&q_empty[qs]);
    }
  };

  int kv = 0, nt = 0;
  for (int n = 0;; ++n, ++nt) {
    const int tile = snake_tile(n, blockIdx.x, gridDim.x);
    if (tile >= n_tiles) break;
    const DqTile<BK> w(tile, BH, Sq, Sk, causal);
    n_kt = w.n_kt;
    q0 = w.q0;
    const int row_lo = q0 + wg * 64 + wl * 16 + g;
    qpos_lo = offset + row_lo;
    const int64_t r = static_cast<int64_t>(w.bh) * Sq + row_lo;
    nl_lo = -lse[r] * kLog2e;
    nl_hi = -lse[r + 8] * kLog2e;
    nd_lo = -delta[r] * scale;
    nd_hi = -delta[r + 8] * scale;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // First turn: S and dP of key tile 0.
    const int s0 = kv % kBwdStages;
    qs = nt % kQSlots;
    const unsigned char* q_t = q_wg + qs * C::kQTile;
    const unsigned char* do_t = do_wg + qs * C::kQTile;
    mbar_wait(&q_full[qs], (nt / kQSlots) & 1);
    mbar_wait(&k_full[s0], (kv / kBwdStages) & 1);
    mbar_wait(&v_full[s0], (kv / kBwdStages) & 1);
    if (wg == NC - 1) named_arrive(1);   // warpgroup 0 goes first
    named_sync(1 + wg);
    wgmma_fence();
    issue_ss<BK, D>(sc, q_t, kBox, k_s + s0 * C::kKTile, C::kKBox);
    wgmma_commit();
    issue_ss<BK, D>(dp, do_t, kBox, v_s + s0 * C::kKTile, C::kKBox);
    wgmma_commit();
    named_arrive(1 + (wg + 1) % NC);
    wgmma_wait<1>();
    reg_fence(sc);
    probs(0);
    wgmma_wait<0>();
    reg_fence(dp);
    release_v(0, s0);
    dscores();
    pack_a<BK>(pa, sc);

    for (int it = 1; it < n_kt; ++it) {
      const int s = (kv + it) % kBwdStages, sp = (kv + it - 1) % kBwdStages;
      const uint32_t parity = ((kv + it) / kBwdStages) & 1;
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);
      named_sync(1 + wg);
      wgmma_fence();
      issue_ss<BK, D>(sc, q_t, kBox, k_s + s * C::kKTile, C::kKBox);
      wgmma_commit();
      issue_ss<BK, D>(dp, do_t, kBox, v_s + s * C::kKTile, C::kKBox);
      wgmma_commit();
      issue_rs_tb<BK, D>(acc, pa, k_s + sp * C::kKTile, C::kKBox);
      wgmma_commit();
      named_arrive(1 + (wg + 1) % NC);
      wgmma_wait<2>();                   // S done; dP and dQ may still run
      reg_fence(sc);
      probs(it);
      wgmma_wait<1>();
      reg_fence(dp);
      release_v(it, s);
      dscores();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      if (lane == 0) mbar_arrive(&k_empty[sp]);
      pack_a<BK>(pa, sc);
    }

    // Last turn: dQ of the last key tile.  The last warpgroup gives no
    // turn back, so the arrivals on each barrier match its waits.
    const int sl = (kv + n_kt - 1) % kBwdStages;
    named_sync(1 + wg);
    wgmma_fence();
    issue_rs_tb<BK, D>(acc, pa, k_s + sl * C::kKTile, C::kKBox);
    wgmma_commit();
    if (wg != NC - 1) named_arrive(1 + (wg + 1) % NC);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    if (lane == 0) mbar_arrive(&k_empty[sl]);
    kv += n_kt;

    __nv_bfloat16* dq_lo = dq + r * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dq_lo + 8 * j, acc[4 * j], acc[4 * j + 1]);
      store2(dq_lo + 8 * D + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
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

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, D] bf16, row-major, read in boxes of box_rows x 64 columns
// (128 bytes: one swizzle span) with the 128-byte swizzle.
bool tensor_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                int64_t rows, int D, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count: the size of a persistent grid.
cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Dynamic shared memory of the bf16 forward: alignment slack, Q and the
// K/V ring, the mbarriers.
constexpr int fwd_wgmma_smem(int D) {
  return 1024 + (D / 64) * (128 * (D == 64 ? 192 : 128) + 2 * kStages * kBox) +
         (2 + 4 * kStages) * 8;
}

template <int D>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, int BH, int G, int Sq, int Sk, float scale,
                      int causal, cudaStream_t stream) {
  using C = FwdCfg<D>;
  constexpr int smem = fwd_wgmma_smem(D);
  static_assert(fwd_wgmma_smem(D) ==
                1024 + (D / 64) * (C::kBQ * 128 + 2 * kStages * kBox) +
                    (2 + 4 * kStages) * 8, "shared-memory layout");
  if (Sq % 128 || Sk % kBK) return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // The maps hold the tensors' addresses, so they are encoded per call
  // (host arithmetic only) and passed by value as __grid_constant__.
  CUtensorMap tq, tk, tv;
  if (!tensor_map(fn, &tq, q, static_cast<int64_t>(BH) * Sq, D, C::kBQ) ||
      !tensor_map(fn, &tk, k, static_cast<int64_t>(BH / G) * Sk, D, kBK) ||
      !tensor_map(fn, &tv, v, static_cast<int64_t>(BH / G) * Sk, D, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // Persistent: one block per SM (at most one per work tile).
  int n_sm = 0;
  if (err == cudaSuccess) err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D>
      <<<min((Sq + C::kBQ - 1) / C::kBQ * BH, n_sm), C::kThreads, smem,
         stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o),
          static_cast<float*>(lse), BH, Sq, Sk, G, scale, causal);
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

// B2 in bf16: Q, dO, K, V through TMA maps; lse and delta by bulk copy.
template <int D>
cudaError_t bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int BHkv,
                           int G, int Sq, int Sk, float scale, int causal,
                           cudaStream_t stream) {
  using C = DkdvCfg<D>;
  if (Sq % 128 || Sk % 128) return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int64_t q_rows = static_cast<int64_t>(BHkv) * G * Sq;
  const int64_t k_rows = static_cast<int64_t>(BHkv) * Sk;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(fn, &tq, q, q_rows, D, C::kBQ) ||
      !tensor_map(fn, &tdo, dout, q_rows, D, C::kBQ) ||
      !tensor_map(fn, &tk, k, k_rows, D, 128) ||
      !tensor_map(fn, &tv, v, k_rows, D, 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int n_sm = 0;
  if (err == cudaSuccess) err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<min(BHkv * (Sk / 128), n_sm), kBwdThreads, C::kSmem, stream>>>(
          tq, tdo, tk, tv, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), BHkv, Sq, Sk, G, scale, causal);
  return cudaGetLastError();
}

// B3 in bf16.
template <int D>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dq, int BH, int G, int Sq,
                         int Sk, float scale, int causal,
                         cudaStream_t stream) {
  using C = DqCfg<D>;
  if (Sq % 128 || Sk % 128) return cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int64_t q_rows = static_cast<int64_t>(BH) * Sq;
  const int64_t k_rows = static_cast<int64_t>(BH / G) * Sk;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(fn, &tq, q, q_rows, D, 128) ||
      !tensor_map(fn, &tdo, dout, q_rows, D, 128) ||
      !tensor_map(fn, &tk, k, k_rows, D, C::kBK) ||
      !tensor_map(fn, &tv, v, k_rows, D, C::kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int n_sm = 0;
  if (err == cudaSuccess) err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D>
      <<<min(Sq / 128 * BH, n_sm), kBwdThreads, C::kSmem, stream>>>(
          tq, tdo, tk, tv, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
          BH, Sq, Sk, G, scale, causal);
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
    return D == 64 ? fwd_wgmma<64>(q, k, v, o, lse, BH, G, Sq, Sk, scale,
                                   causal, s)
                   : fwd_wgmma<128>(q, k, v, o, lse, BH, G, Sq, Sk, scale,
                                    causal, s);
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
    return D == 64 ? bwd_dkdv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv,
                                        BHkv, G, Sq, Sk, scale, causal, s)
                   : bwd_dkdv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv,
                                         BHkv, G, Sq, Sk, scale, causal, s);
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
    return D == 64 ? bwd_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, BH, G,
                                      Sq, Sk, scale, causal, s)
                   : bwd_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, BH, G,
                                       Sq, Sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the forward kernel for (D, dtype).
extern "C" int rtt_flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 1) return D == 64 ? fwd_wgmma_smem(64) : fwd_wgmma_smem(128);
  return (3 * kTile * (D + 4) + kTile * (kTile + 4)) * 4;
}

// Dynamic shared memory (bytes) of the bf16 backward kernel B2 (dq = 0)
// or B3 (dq = 1) at head dim D.
extern "C" int rtt_flash_bwd_smem_bytes(int D, int dq) {
  if (dq) return D == 64 ? DqCfg<64>::kSmem : DqCfg<128>::kSmem;
  return D == 64 ? DkdvCfg<64>::kSmem : DkdvCfg<128>::kSmem;
}

extern "C" const char* rtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
