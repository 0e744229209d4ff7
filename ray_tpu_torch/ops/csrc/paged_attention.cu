// Ragged paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` in
// ray_tpu/ops/paged_attention.py (launched by `_paged_fwd`).  Same
// function: one query token per sequence attends that sequence's KV,
// which lives in fixed-size blocks of a shared pool and is addressed
// through a per-sequence block table; positions at or past
// `context_lens[b]` are never read (the "ragged" part), scores and the
// softmax are f32 per query head of the GQA group, P.V multiplies f32
// probabilities by V converted to f32 (no bf16 rounding of p), and a
// sequence with ctx == 0 gets zeros (l == 0 -> 1).
//
//   q            [B, H, D]            f32 or bf16, H = Hkv * G
//   k_pool       [NB, bs, Hkv, D]     one layer's pool, q's dtype
//   v_pool       [NB, bs, Hkv, D]
//   block_tables [B, W] int32         physical block per logical block
//   context_lens [B]    int32         valid positions per sequence
//   out          [B, H, D]            q's dtype
//
// What bounds it on an H100: the bytes of cached K and V it must read,
// sum_b ctx_b * Hkv * D * 2 * sizeof(dtype), over 3.35 TB/s (2.7 MB,
// under a microsecond at the serving shapes); the arithmetic
// (4 * ctx * H * D flops) is far below the card's rate.  So the real
// limit at decode sizes is latency: how many dependent trips to memory
// the longest sequence makes, and how many SMs have loads in flight.
//
// Design ("flash-decoding": split the context into fixed partitions).
//   * Grid (P, Hkv, B): partition p of a sequence covers `part_blocks`
//     whole KV blocks (at most 64 tokens), P = ceil(W / part_blocks)
//     from the shapes alone.  Nothing on the host reads context_lens;
//     a partition that starts at or past ctx exits at once and writes
//     the empty state (m = NEG_INF, l = 0).  A long context is spread
//     over P blocks on as many SMs instead of one block walking it.
//   * One block of 8 warps per (partition, kv head, sequence) reads its
//     slice of the block-table row once, then issues EVERY K and V row
//     of the partition as 16-byte cp.async copies into shared memory
//     (K first, V second, two commit groups) before any arithmetic:
//     the partition's loads are all in flight together, and the V
//     copies land while the scores are computed.  Rows are padded by 16
//     bytes so the 16-byte reads of the score loop hit distinct banks.
//   * Scores: thread (token t, head set) dots q (f32, shared) with K row
//     t for a quarter of the G heads; one warp per head reduces max and
//     sum and writes p = exp(s - m) in f32; P.V: thread (column d, head
//     set) sums p * v over the partition's tokens in f32.  256 threads
//     beat 128 on the card: the chain of dependent shared-memory reads
//     each thread runs is half as long.
//   * Partials (m, l, unnormalised acc[G][D]) go to f32 scratch
//     [B, H, P] and [B, H, P, D] that the caller allocates.  A second,
//     small kernel (grid (H, B), one thread per column) merges the
//     non-empty partitions of each (sequence, head) by the logsumexp
//     rule and normalises a row with l == 0 by 1.  It is launched as a
//     programmatic dependent (griddepcontrol), so its launch overlaps
//     the partition kernel and it waits on device for the partials.
//     With P == 1 (decided on the host from the shapes) the partition
//     kernel writes `out` itself and the merge is not launched.  No
//     state outlives a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxGroup = 8;        // query heads per kv head
constexpr int kMaxBlock = 64;       // tokens per KV block
constexpr int kMaxPart = 64;        // tokens per partition
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 contiguous elements (16-byte aligned, shared memory) -> f32.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one partition block (fixed, from kMaxPart).
template <typename T, int D>
struct Smem {
  static constexpr int kRow = D * (int)sizeof(T) + 16;  // padded row bytes
  static constexpr int kK = 0;
  static constexpr int kV = kK + kMaxPart * kRow;
  static constexpr int kQ = kV + kMaxPart * kRow;              // f32 [G][D]
  static constexpr int kS = kQ + kMaxGroup * D * 4;            // f32 [G][64]
  static constexpr int kBt = kS + kMaxGroup * kMaxPart * 4;    // int [64]
  static constexpr int kM = kBt + kMaxPart * 4;                // f32 [G]
  static constexpr int kL = kM + kMaxGroup * 4;                // f32 [G]
  static constexpr int kBytes = kL + kMaxGroup * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_partition_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, float* __restrict__ m_part,
                       float* __restrict__ l_part,
                       float* __restrict__ acc_part, int Hkv, int G, int bs,
                       int W, int part_blocks, int P, float scale) {
  using L = Smem<T, D>;
  constexpr int kChunks = D * (int)sizeof(T) / 16;   // 16-byte pieces/row
  constexpr int kScoreSets = kThreads / kMaxPart;    // scores: head sets
  constexpr int kHeadSets = kThreads / D;            // P.V: head sets
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem + L::kK;
  unsigned char* v_s = smem + L::kV;
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  int* bt_s = reinterpret_cast<int*>(smem + L::kBt);
  float* m_s = reinterpret_cast<float*>(smem + L::kM);
  float* l_s = reinterpret_cast<float*>(smem + L::kL);

  // The merge kernel may be scheduled now; it waits on device for this
  // grid to finish before it reads a partial.
  asm volatile("griddepcontrol.launch_dependents;");
  const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part_tokens = part_blocks * bs;
  const int start = p * part_tokens;
  // Query heads h*G .. h*G+G-1 share kv head h (q.reshape(B,Hkv,G,D)).
  const int64_t head0 = ((int64_t)b * Hkv + h) * G;   // row of [B*H]
  // The table slice, the context length and q have no dependence on one
  // another: all three loads are in flight together.
  const int w = p * part_blocks + tid;
  const int bt_val =
      tid < part_blocks && w < W ? block_tables[(int64_t)b * W + w] : 0;
  const int ctx = min(max(context_lens[b], 0), W * bs);
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_float(q[head0 * D + i]);

  if (start >= ctx) {                    // empty partition
    if (P == 1) {                        // ctx == 0: zeros, written here
      for (int i = tid; i < G * D; i += kThreads)
        store(out + head0 * D + i, 0.f);
      return;
    }
    if (tid < G) {
      m_part[(head0 + tid) * P + p] = kNegInf;
      l_part[(head0 + tid) * P + p] = 0.f;
    }
    return;
  }
  {
    const int n_tok = min(part_tokens, ctx - start);
    if (tid < (n_tok + bs - 1) / bs) bt_s[tid] = bt_val;
    __syncthreads();

    // Every K row, then every V row, of the partition in flight at once.
    const int64_t pos_stride = (int64_t)Hkv * D;
    for (int i = tid; i < n_tok * kChunks; i += kThreads) {
      const int t = i / kChunks, c = i % kChunks;
      const int64_t row =
          ((int64_t)bt_s[t / bs] * bs + t % bs) * pos_stride + (int64_t)h * D;
      cp_async16(k_s + t * L::kRow + c * 16,
                 reinterpret_cast<const unsigned char*>(k_pool + row) +
                     c * 16);
    }
    cp_async_commit();
    for (int i = tid; i < n_tok * kChunks; i += kThreads) {
      const int t = i / kChunks, c = i % kChunks;
      const int64_t row =
          ((int64_t)bt_s[t / bs] * bs + t % bs) * pos_stride + (int64_t)h * D;
      cp_async16(v_s + t * L::kRow + c * 16,
                 reinterpret_cast<const unsigned char*>(v_pool + row) +
                     c * 16);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // K has landed (V may not yet)
    __syncthreads();

    // Scores s[g][t] = scale * q_g . k_t: thread (t, head set).
    {
      const int t = tid % kMaxPart, hs = tid / kMaxPart;
      if (t < n_tok) {
        const T* krow = reinterpret_cast<const T*>(k_s + t * L::kRow);
        float acc[kMaxGroup / kScoreSets];
#pragma unroll
        for (int j = 0; j < kMaxGroup / kScoreSets; ++j) acc[j] = 0.f;
#pragma unroll 2
        for (int e0 = 0; e0 < D; e0 += 8) {
          float kf[8];
          load8(krow + e0, kf);
#pragma unroll
          for (int j = 0; j < kMaxGroup / kScoreSets; ++j) {
            const int g = hs + kScoreSets * j;
            if (g < G) {                              // uniform per warp
              const float* qg = q_s + g * D + e0;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[j] = fmaf(qg[e], kf[e], acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxGroup / kScoreSets; ++j) {
          const int g = hs + kScoreSets * j;
          if (g < G) s_s[g * kMaxPart + t] = acc[j] * scale;
        }
      }
    }
    __syncthreads();

    // Softmax over the partition, one warp per query head.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = s_s + g * kMaxPart;
      const float s0 = lane < n_tok ? sg[lane] : kNegInf;
      const float s1 = lane + 32 < n_tok ? sg[lane + 32] : kNegInf;
      const float m = warp_max(fmaxf(s0, s1));
      const float p0 = lane < n_tok ? expf(s0 - m) : 0.f;
      const float p1 = lane + 32 < n_tok ? expf(s1 - m) : 0.f;
      if (lane < n_tok) sg[lane] = p0;
      if (lane + 32 < n_tok) sg[lane + 32] = p1;
      const float l = warp_sum(p0 + p1);
      if (lane == 0) {
        m_s[g] = m;
        l_s[g] = l;
      }
    }
    cp_async_wait<0>();                  // V has landed
    __syncthreads();

    // acc[g][d] = sum_t p[g][t] * v[t][d], f32: thread (column d, head
    // set).
    const int d = tid % D, hs = tid / D;
    float acc[kMaxGroup / kHeadSets];
#pragma unroll
    for (int j = 0; j < kMaxGroup / kHeadSets; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_tok; ++t) {
      const float vv =
          to_float(reinterpret_cast<const T*>(v_s + t * L::kRow)[d]);
#pragma unroll
      for (int j = 0; j < kMaxGroup / kHeadSets; ++j) {
        const int g = hs + kHeadSets * j;
        if (g < G) acc[j] = fmaf(s_s[g * kMaxPart + t], vv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup / kHeadSets; ++j) {
      const int g = hs + kHeadSets * j;
      if (g >= G) continue;
      const int64_t row = head0 + g;
      if (P == 1) {
        const float l = l_s[g];
        store(out + row * D + d, acc[j] / (l == 0.f ? 1.f : l));
      } else {
        acc_part[(row * P + p) * D + d] = acc[j];
        if (d == 0) {
          m_part[row * P + p] = m_s[g];
          l_part[row * P + p] = l_s[g];
        }
      }
    }
  }
}

// out[b, head] from the P partials of (b, head): the logsumexp rule over
// the partitions that hold a position (l > 0; only the first
// ceil(ctx / part_tokens) can), l == 0 normalised by 1.  Thread d of
// block (head, b) writes column d.  Two passes (max, then weights): no
// chain of dependent exponentials through a running max.
template <typename T>
__global__ void paged_merge_kernel(const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   const float* __restrict__ acc_part,
                                   const int* __restrict__ context_lens,
                                   T* __restrict__ out, int H, int D,
                                   int part_tokens, int max_ctx, int P) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = (int64_t)b * H + head;
  const int ctx = min(max(context_lens[b], 0), max_ctx);
  const int n_used = min(P, (ctx + part_tokens - 1) / part_tokens);
  // Launched as a programmatic dependent of the partition kernel: wait
  // until that grid has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float m_max = kNegInf;
#pragma unroll 4
  for (int j = 0; j < n_used; ++j)
    if (l_part[row * P + j] > 0.f) m_max = fmaxf(m_max, m_part[row * P + j]);
  float l_sum = 0.f, o = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_used; ++j) {
    const float lj = l_part[row * P + j];
    if (lj > 0.f) {
      const float wj = expf(m_part[row * P + j] - m_max);
      l_sum = fmaf(wj, lj, l_sum);
      o = fmaf(wj, acc_part[(row * P + j) * D + d], o);
    }
  }
  store(out + row * D + d, o / (l_sum == 0.f ? 1.f : l_sum));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* context_lens,
                   void* out, float* partials, int B, int Hkv, int G,
                   int bs, int W, int part_blocks, int P, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_partition_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // partials: m [B*H, P], then l [B*H, P], then acc [B*H, P, D].
  const int64_t n_rows = (int64_t)B * Hkv * G * P;
  float* m_part = partials;
  float* l_part = partials ? partials + n_rows : nullptr;
  float* acc_part = partials ? partials + 2 * n_rows : nullptr;
  paged_partition_kernel<T, D><<<dim3(P, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, context_lens,
      static_cast<T*>(out), m_part, l_part, acc_part, Hkv, G, bs, W,
      part_blocks, P, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return err;
  // Programmatic dependent launch: the merge's launch overlaps the
  // partition kernel's run instead of following its end.
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * G, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<T>,
                            static_cast<const float*>(m_part),
                            static_cast<const float*>(l_part),
                            static_cast<const float*>(acc_part),
                            context_lens, static_cast<T*>(out), Hkv * G, D,
                            part_blocks * bs, W * bs, P);
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* bt, const int* cl, void* out, float* partials,
                     int B, int Hkv, int G, int bs, int W, int part_blocks,
                     int P, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, bt, cl, out, partials, B, Hkv, G, bs, W,
                         part_blocks, P, scale, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, bt, cl, out, partials, B, Hkv, G, bs, W,
                          part_blocks, P, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `part_blocks` KV blocks per
// partition (part_blocks * bs <= 64) and P = ceil(W / part_blocks)
// partitions, both from the shapes (ops/paged_attention.py split_plan).
// `partials` is f32 scratch the caller allocates, B * H * P * (D + 2)
// floats (m and l [B, H, P], then acc [B, H, P, D]); unused (may be
// null) when P == 1, where one kernel runs; else the partition kernel
// and then the merge kernel run.  Returns the cudaError_t of the
// launches (0 = success).  Launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int rtt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool,
                                   const void* block_tables,
                                   const void* context_lens, void* out,
                                   void* partials, int B, int Hkv, int G,
                                   int D, int bs, int W, int part_blocks,
                                   int P, float scale, int dtype,
                                   void* stream) {
  if (G < 1 || G > kMaxGroup || bs < 1 || bs > kMaxBlock || Hkv < 1 ||
      W < 1 || B < 0 || part_blocks < 1 || part_blocks * bs > kMaxPart ||
      P != (W + part_blocks - 1) / part_blocks || (P > 1 && !partials))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k_pool, v_pool, bt, cl, out, part, B, Hkv,
                           G, bs, W, part_blocks, P, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, bt, cl, out, part,
                                   B, Hkv, G, bs, W, part_blocks, P, scale,
                                   s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the partition kernel for (D, dtype).
extern "C" int rtt_paged_smem_bytes(int D, int dtype) {
  if (dtype == 0) return D == 64 ? Smem<float, 64>::kBytes
                                 : Smem<float, 128>::kBytes;
  return D == 64 ? Smem<__nv_bfloat16, 64>::kBytes
                 : Smem<__nv_bfloat16, 128>::kBytes;
}

extern "C" const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
