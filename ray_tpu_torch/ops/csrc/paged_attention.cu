// Ragged paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` in
// ray_tpu/ops/paged_attention.py (launched by `_paged_fwd`).  Same
// function: one query token per sequence attends that sequence's KV,
// which lives in fixed-size blocks of a shared pool and is addressed
// through a per-sequence block table; blocks past `context_lens[b]` are
// never touched (the "ragged" part), positions past it inside the last
// block are masked, the softmax is online in f32 per query head of the
// GQA group, and a sequence with ctx == 0 gets zeros (l == 0 -> 1).
//
//   q            [B, H, D]            f32 or bf16, H = Hkv * G
//   k_pool       [NB, bs, Hkv, D]     one layer's pool, q's dtype
//   v_pool       [NB, bs, Hkv, D]
//   block_tables [B, W] int32         physical block per logical block
//   context_lens [B]    int32         valid positions per sequence
//   out          [B, H, D]            q's dtype
//
// Design.  The TPU grid (B, Hkv, W) runs in order on one core and
// carries the softmax state across w in VMEM scratch; CUDA blocks run in
// parallel and in no order, so here one thread block owns one
// (sequence, kv head) pair and walks its block-table row in a loop over
// ceil(ctx / bs) blocks, keeping the running max, normalizer and
// accumulator of its G query heads on chip.  blockDim = D threads:
//   * scores: D/8 lanes share one K row (8 contiguous elements each, one
//     16-byte load in bf16), 8 rows per pass, reduced with shuffles;
//   * softmax: one warp per query head updates m, l and the rescale;
//   * P.V: thread d owns output column d of all G heads in registers.
//
// What bounds it on an H100: the bytes of cached K and V it must read,
// sum_b ctx_b * Hkv * D * 2 * sizeof(dtype), over 3.35 TB/s; the
// arithmetic (4 * ctx * H * D flops) is far below the card's rate.
// What the design does about it: it reads only the blocks below ctx,
// each K and V row exactly once, with coalesced loads, and keeps every
// intermediate (scores, probabilities, accumulators) in shared memory
// or registers.  It does not yet hide load latency (no cp.async/TMA
// pipeline) or split long contexts across blocks, so with few
// sequences it fills a fraction of the SMs; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxGroup = 8;        // query heads per kv head
constexpr int kMaxBlock = 64;       // tokens per KV block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 contiguous elements (16-byte aligned) -> f32.
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, int Hkv, int G, int bs, int W,
                       float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kLanesPerRow = D / 8;               // 8 or 16
  constexpr int kRowsPerPass = D / kLanesPerRow;    // 8
  const int h = blockIdx.x;                         // kv head
  const int b = blockIdx.y;                         // sequence
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = tid / kLanesPerRow, sub = tid % kLanesPerRow;

  __shared__ float q_s[kMaxGroup][D];
  __shared__ float p_s[kMaxGroup][kMaxBlock];       // scores, then probs
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  // Query heads h*G .. h*G+G-1 share kv head h (q.reshape(B,Hkv,G,D)).
  const int64_t q_off = ((int64_t)b * Hkv + h) * G * D;
  for (int g = 0; g < G; ++g) q_s[g][tid] = to_float(q[q_off + g * D + tid]);
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const int ctx = min(max(context_lens[b], 0), W * bs);
  const int n_blocks = (ctx + bs - 1) / bs;
  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t blk_stride = (int64_t)bs * pos_stride;
  __syncthreads();

  for (int w = 0; w < n_blocks; ++w) {
    const int64_t base =
        (int64_t)block_tables[(int64_t)b * W + w] * blk_stride +
        (int64_t)h * D;
    const T* k_blk = k_pool + base;
    const T* v_blk = v_pool + base;
    const int n_valid = min(bs, ctx - w * bs);      // >= 1

    // Scores s[g][t] = scale * q_g . k_t for the valid rows only.
    for (int t0 = 0; t0 < n_valid; t0 += kRowsPerPass) {
      const int t = t0 + row;
      float kf[8];
      if (t < n_valid) {
        load8(k_blk + t * pos_stride + sub * 8, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {                                // uniform branch
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += q_s[g][sub * 8 + e] * kf[e];
#pragma unroll
          for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (sub == 0 && t < n_valid) p_s[g][t] = s * scale;
        }
      }
    }
    __syncthreads();

    // Online softmax update, one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = lane < n_valid ? p_s[g][lane] : kNegInf;
      const float s1 = lane + 32 < n_valid ? p_s[g][lane + 32] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n_valid ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n_valid ? expf(s1 - m_new) : 0.f;
      if (lane < n_valid) p_s[g][lane] = p0;
      if (lane + 32 < n_valid) p_s[g][lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g] (column tid) = alpha_g * acc[g] + sum_t p[g][t] * v[t][tid].
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] *= alpha_s[g];
#pragma unroll 4
    for (int t = 0; t < n_valid; ++t) {
      const float vv = to_float(v_blk[t * pos_stride + tid]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += p_s[g][t] * vv;
    }
    __syncthreads();                                // p_s reused next block
  }

  T* o = out + q_off;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float l = l_s[g];
      store(o + g * D + tid, acc[g] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T>
cudaError_t launch(int D, const void* q, const void* k_pool,
                   const void* v_pool, const int* block_tables,
                   const int* context_lens, void* out, int B, int Hkv,
                   int G, int bs, int W, float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  if (D == 64) {
    paged_attention_kernel<T, 64><<<grid, 64, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), block_tables, context_lens,
        static_cast<T*>(out), Hkv, G, bs, W, scale);
  } else if (D == 128) {
    paged_attention_kernel<T, 128><<<grid, 128, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), block_tables, context_lens,
        static_cast<T*>(out), Hkv, G, bs, W, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = success).  Launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int rtt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool,
                                   const void* block_tables,
                                   const void* context_lens, void* out,
                                   int B, int Hkv, int G, int D, int bs,
                                   int W, float scale, int dtype,
                                   void* stream) {
  if (G < 1 || G > kMaxGroup || bs < 1 || bs > kMaxBlock || Hkv < 1 ||
      W < 1 || B < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(D, q, k_pool, v_pool, bt, cl, out, B, Hkv, G, bs,
                         W, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(D, q, k_pool, v_pool, bt, cl, out, B, Hkv,
                                 G, bs, W, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
