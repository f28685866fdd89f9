// Paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::
// paged_attention (_paged_kernel, lines 44-92).  One decode token per
// sequence attends over a paged KV cache:
//   q        (B, KV, G, Dh)            f32 or bf16
//   k/v      (P, page_size, KV, Dh)    f32 or bf16 (independently of q)
//   tables   (B, max_blocks) int32     logical page -> physical page
//   ctx_lens (B,) int32                the query sits at position ctx - 1
//   out      (B, KV, G, Dh)            q's dtype
// Logits are f32 times Dh^-0.5, optionally softcap * tanh(s / softcap),
// masked to lo <= j <= ctx - 1 with lo = max(ctx - window, 0) when
// window > 0; softmax runs online with f32 m, l and acc; the result is
// acc / max(l, 1e-30).
//
// window <= 0 means full attention here, as in the TPU kernel
// (paged_attention.py:61).  The gather path of models/layers.py reads only
// window == -1 as full; -1 is the only non-positive window the configs use,
// so the two readings agree on every config.
//
// Bound on the H100: device-memory bytes.  The least work reads each live
// KV token once, sum_b live_tokens_b * KV * Dh * 2 (k and v) * itemsize,
// plus q and out; the arithmetic is 4 * G * Dh flops per live token and
// head, far below the bf16 ridge of ~295 flops per byte.
//
// Design.  The TPU kernel walks a sequential page grid axis with its
// accumulators in VMEM and the block table in scalar prefetch.  Here one
// thread block serves one (sequence b, kv head h) pair, reads its own
// block-table row, ctx_lens[b] and the runtime window, and loops over
// tiles of kTile = 32 tokens from the first live token lo to ctx - 1, so
// pages left of the window or past the context are never read.  blockDim
// is Dh: thread d owns output column d of all G query rows (acc[G] in
// registers), and warp w owns columns 32w .. 32w + 31.  Per tile:
//   0. the tile's row offsets go to shared memory (one block-table read
//      per token); then every k and v load of the tile is issued before
//      any arithmetic, so the tile pays one memory latency, not one per
//      token.  Lane t loads warp w's 32 columns of token t's k row with
//      16-byte loads; thread d loads column d of each v row (coalesced);
//   1. lane t forms the G partial dot products of token t over its warp's
//      32 columns against the scaled q rows (in shared memory, read as
//      broadcasts) and writes them to shared memory: no shuffles;
//   2. warp w takes rows w, w + nwarps, ...: lane t sums token t's
//      partials over the warps, applies the softcap and the mask, and the
//      tile max and sum of the online softmax are warp reductions;
//   3. PV: thread d accumulates p * v of column d into acc[g].
//
// This design launches only B * KV blocks: 16 for qwen2-1.5b (KV = 2) at
// 8 slots, on 132 SMs, so a decode step leaves most of the card idle and
// is latency-bound in the serial tile loop.  Splitting each sequence's
// tokens across blocks (split-K decode, with a second pass that combines
// the partial m, l and acc) is the first fix, for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxG = 16;     // query rows per kv head
constexpr int kMaxDh = 256;   // head dim, a multiple of 32
constexpr int kTile = 32;     // tokens per tile: one lane per token in step 2
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// the 32 consecutive elements at `p` (16-byte aligned) as floats
__device__ __forceinline__ void load32(const float* p, float (&x)[32]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = p4[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load32(const __nv_bfloat16* p,
                                       float (&x)[32]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 u = p4[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[8 * i + 2 * j] = f.x;
      x[8 * i + 2 * j + 1] = f.y;
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kMaxDh) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, TQ* __restrict__ out, int num_kv,
    int groups, int head_dim, int page_size, int max_blocks, int window,
    float scale, float softcap) {
  __shared__ __align__(16) float q_s[kMaxG * kMaxDh];
  __shared__ float part_s[kMaxDh / 32][kMaxG][kTile];  // per-warp partial dots
  __shared__ float p_s[kMaxG][kTile];
  __shared__ size_t row_s[kTile];  // element offset of each token's row
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int d = threadIdx.x;  // blockDim.x == head_dim
  const int lane = d & 31;
  const int warp = d >> 5;
  const int n_warps = head_dim >> 5;

  // tokens past the table's reach are not in the cache at all
  const int ctx = min(ctx_lens[b], max_blocks * page_size);
  const int pos = ctx - 1;
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int* bt = block_tables + static_cast<size_t>(b) * max_blocks;
  const size_t token_stride = static_cast<size_t>(num_kv) * head_dim;
  const TKV* kh = k_pages + static_cast<size_t>(h) * head_dim;
  const TKV* vh = v_pages + static_cast<size_t>(h) * head_dim;

  const size_t qo = (static_cast<size_t>(b) * num_kv + h) * groups * head_dim;
  for (int g = 0; g < groups; ++g)
    q_s[g * head_dim + d] = to_f32(q[qo + g * head_dim + d]) * scale;
  if (d < groups) {
    m_s[d] = kNegInf;
    l_s[d] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int t0 = lo; t0 < ctx; t0 += kTile) {
    const int n = min(kTile, ctx - t0);
    if (d < n) {
      const int j = t0 + d;
      row_s[d] = (static_cast<size_t>(bt[j / page_size]) * page_size +
                  j % page_size) * token_stride;
    }
    __syncthreads();

    // every load of the tile is issued before any arithmetic: lane t takes
    // this warp's 32 columns of token t's k row (16-byte loads), thread d
    // column d of every v row (coalesced across the block)
    float kx[32];
    if (lane < n) {
      load32(kh + row_s[lane] + warp * 32, kx);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) kx[e] = 0.f;
    }
    float vx[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      vx[t] = t < n ? to_f32(vh[row_s[t] + d]) : 0.f;

    // 1. partial logits of token `lane` over this warp's 32 columns
    for (int g = 0; g < groups; ++g) {
      const float4* q4 =
          reinterpret_cast<const float4*>(q_s + g * head_dim + warp * 32);
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = q4[i];  // the same address in every lane: broadcast
        x += qv.x * kx[4 * i] + qv.y * kx[4 * i + 1] + qv.z * kx[4 * i + 2] +
             qv.w * kx[4 * i + 3];
      }
      part_s[warp][g][lane] = x;
    }
    __syncthreads();

    // 2. logits (sum of the warps' partials, softcap) and the online
    // softmax update: warp w takes rows w, w + n_warps, ...; lane = token
    for (int g = warp; g < groups; g += n_warps) {
      const bool live = lane < n;
      float x = 0.f;
      for (int w = 0; w < n_warps; ++w) x += part_s[w][g][lane];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = live ? x : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = live ? expf(x - m_new) : 0.f;  // 0 past the tile's end
      const float tile_sum = warp_sum(p);
      p_s[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + tile_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = alpha * acc + p @ v, column d.  The next tile's first
    // barrier orders these reads of p_s before its writes.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < groups) {
        float a = acc[g] * alpha_s[g];
#pragma unroll
        for (int t = 0; t < kTile; ++t) a += p_s[g][t] * vx[t];
        acc[g] = a;
      }
    }
  }
  __syncthreads();  // l_s is final (and set even when no tile ran)

#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < groups)
      out[qo + g * head_dim + d] =
          from_f32<TQ>(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* ctx_lens, void* out,
           int batch, int num_kv, int groups, int head_dim, int page_size,
           int max_blocks, int window, float scale, float softcap,
           cudaStream_t stream) {
  paged_attention_kernel<TQ, TKV>
      <<<dim3(batch, num_kv), head_dim, 0, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
          static_cast<const TKV*>(v_pages),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(ctx_lens), static_cast<TQ*>(out), num_kv,
          groups, head_dim, page_size, max_blocks, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  softcap <= 0 means no softcap.  The caller checks shapes,
// dtypes, devices and contiguity; the limits are re-checked here.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* ctx_lens, void* out, int batch,
    int num_kv, int groups, int head_dim, int page_size, int max_blocks,
    int window, float scale, float softcap, int q_bf16, int kv_bf16,
    void* stream) {
  if (groups < 1 || groups > kMaxG || head_dim < 32 || head_dim > kMaxDh ||
      head_dim % 32 != 0 || page_size < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, block_tables, ctx_lens, out, batch, num_kv,
        groups, head_dim, page_size, max_blocks, window, scale, softcap, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(
        q, k_pages, v_pages, block_tables, ctx_lens, out, batch, num_kv,
        groups, head_dim, page_size, max_blocks, window, scale, softcap, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(
        q, k_pages, v_pages, block_tables, ctx_lens, out, batch, num_kv,
        groups, head_dim, page_size, max_blocks, window, scale, softcap, s);
  return launch<float, float>(q, k_pages, v_pages, block_tables, ctx_lens,
                                out, batch, num_kv, groups, head_dim,
                                page_size, max_blocks, window, scale, softcap,
                                s);
}
