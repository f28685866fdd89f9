// Paged-attention decode kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernel repro/kernels/paged_attention.py::
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
// acc / max(l, 1e-30), so a row with no live token (ctx <= 0) gives 0.
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
// Design: split-K decode in two launches.  A decode step has only B * KV
// (sequence, kv head) rows (16 for qwen2-1.5b at 8 slots), far fewer than
// the 132 SMs, so each row's context is split across blocks:
//   pass 1 (paged_attention_kernel), grid (split s, kv head h, sequence b):
//     the block reads ctx_lens[b] and the window, finds the row's live
//     range [lo, ctx), and takes the s-th of S equal parts of it, rounded
//     up to `split_tile` tokens.  Its 128 threads form token groups of
//     TPT = Dh / 8 (rounded up to a power of two) lanes: lane c of a group
//     holds columns 8c .. 8c + 7 of a token's k and v rows, read with
//     16-byte loads (a half-warp covers a 128-wide bf16 row), so the group
//     reads whole rows and the block reads several tokens at once.  Each
//     group walks its tokens U at a time with the next U tokens' loads
//     already in registers (prefetch), keeps its own online softmax (m, l
//     and acc for its 8 columns of every query row; the dot products are
//     summed across the group's lanes by shuffles), and so needs no
//     barrier in the token loop.  After the loop the groups' states are
//     merged (shuffles within a warp, shared memory across warps) and the
//     block writes its partial f32 m, l and acc to the scratch buffer; an
//     empty part writes m = -2e38 (the kernel's -inf), l = 0, acc = 0;
//   pass 2 (paged_attention_combine_kernel), a thread an output element:
//     m* = max_s m_s, l = sum_s l_s e^(m_s - m*), and
//     out = sum_s acc_s e^(m_s - m*) / max(l, 1e-30), in q's dtype.
// S is chosen by the caller from the static shapes alone (never from
// ctx_lens, which stays on the device), so a decode step does not sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query rows per kv head
constexpr int kMaxDh = 256;      // head dim, a multiple of 32
constexpr int kMaxSplits = 64;   // parts of a row's context
constexpr float kNegInf = -2.0e38f;

// 8 consecutive elements as raw bits: one 16-byte load for bf16, two for f32
template <typename T>
struct Raw {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void fetch(Raw<T>& r, const T* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i) r.u[i] = __ldg(s + i);
}

__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[8]) {
  const float* f = reinterpret_cast<const float*>(r.u);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = f[e];
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r,
                                      float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Merge the online-softmax state (m_o, l_o, acc_o) into (m, l, acc).  The
// -2e38 of an empty state gives weight 0 against any real max, and 1 to
// two empty states, whose l and acc are 0.
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[8],
                                      float m_o, float l_o,
                                      const float (&acc_o)[8]) {
  const float m_new = fmaxf(m, m_o);
  const float a = expf(m - m_new);
  const float c = expf(m_o - m_new);
  l = l * a + l_o * c;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + acc_o[e] * c;
  m = m_new;
}

// Pass 1.  TPT lanes a token group (a power of two >= Dh / 8), up to GMAX
// query rows held in registers; U tokens a group per step.
template <typename TKV, int TPT, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int num_kv,
    int groups, int head_dim, int page_size, int max_blocks, int window,
    int split_tile, float scale, float softcap) {
  constexpr int kGroups = kThreads / TPT;  // token groups in the block
  // tokens a group loads per step: the prefetched k and v rows take 16
  // (bf16) or 32 (f32) registers a token, twice over
  constexpr int U = (GMAX > 8 ? 2 : 4) / (sizeof(TKV) / 2);
  __shared__ __align__(16) float q_s[kMaxG * kMaxDh];
  __shared__ __align__(16) float red_acc[kMaxG * kMaxDh];
  __shared__ float red_m[kMaxG];
  __shared__ float red_l[kMaxG];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = tid / TPT;  // token group
  const int c = tid % TPT;    // this lane holds columns 8c .. 8c + 7
  const bool live_col = 8 * c < head_dim;

  // the s-th part of the live range [lo, ctx), rounded up to split_tile;
  // tokens past the table's reach are not in the cache at all, but the
  // window's edge is the query's (at ctx_lens[b] - 1) as in the reference
  const int ctx_b = ctx_lens[b];
  const int ctx = min(ctx_b, max_blocks * page_size);
  const int lo = window > 0 ? max(ctx_b - window, 0) : 0;
  const int n_live = max(ctx - lo, 0);
  const int part =
      ((n_live + splits - 1) / splits + split_tile - 1) / split_tile *
      split_tile;
  const int t_begin = lo + s * part;
  const int t_end = min(t_begin + part, ctx);

  const size_t qo = (static_cast<size_t>(b) * num_kv + h) * groups * head_dim;
#pragma unroll 4
  for (int i = tid; i < groups * head_dim; i += kThreads)
    q_s[i] = (q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[qo + i])
                     : static_cast<const float*>(q)[qo + i]) *
             scale;
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const int* bt = block_tables + static_cast<size_t>(b) * max_blocks;
  const size_t token_stride = static_cast<size_t>(num_kv) * head_dim;
  const TKV* kh = k_pages + static_cast<size_t>(h) * head_dim + 8 * c;
  const TKV* vh = v_pages + static_cast<size_t>(h) * head_dim + 8 * c;
  // token u of a step at `base` is base + u * kGroups + grp
  auto load = [&](int base, Raw<TKV>(&kr)[U], Raw<TKV>(&vr)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * kGroups + grp;
      if (j < t_end && live_col) {
        const size_t row =
            (static_cast<size_t>(bt[j / page_size]) * page_size +
             j % page_size) * token_stride;
        fetch(kr[u], kh + row);
        fetch(vr[u], vh + row);
      } else {  // zeros, never stale bits: 0 * NaN would poison the sums
        kr[u] = Raw<TKV>{};
        vr[u] = Raw<TKV>{};
      }
    }
  };

  Raw<TKV> kn[U], vn[U];
  load(t_begin, kn, vn);
  for (int base = t_begin; base < t_end; base += U * kGroups) {
    Raw<TKV> kc[U], vc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
    load(base + U * kGroups, kn, vn);  // the next step's rows fly meanwhile

    float kf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) widen(kc[u], kf[u]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= groups) break;
      // this lane's 8 columns of the scaled query row g
      float qv[8];
      if (live_col) {
        const float4* q4 =
            reinterpret_cast<const float4*>(q_s + g * head_dim + 8 * c);
        const float4 a = q4[0], bq = q4[1];
        qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
        qv[4] = bq.x; qv[5] = bq.y; qv[6] = bq.z; qv[7] = bq.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[e] = 0.f;
      }
      float x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qv[e], kf[u][e], d);
        // the dot product over the group's TPT lanes
#pragma unroll
        for (int o = TPT / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        x[u] = base + u * kGroups + grp < t_end ? d : kNegInf;
      }
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, x[u]);
      const float alpha = expf(m[g] - m_new);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = x[u] > kNegInf ? expf(x[u] - m_new) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        widen(vc[u], vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[u], vf[e], acc[g][e]);
      }
    }
  }

  // merge the token groups of each warp (lanes TPT, 2 TPT, ... apart hold
  // the same columns), then the warps through shared memory into warp 0
#pragma unroll
  for (int o = TPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= groups) break;
      float acc_o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc_o[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge(m[g], l[g], acc[g], m_o, l_o, acc_o);
    }
  }
  const bool writer = lane < TPT && live_col;  // one copy of each column
  for (int w = 1; w < kWarps; ++w) {
    if (warp == w && writer) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= groups) break;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red_acc[g * head_dim + 8 * c + e] = acc[g][e];
        if (c == 0) {
          red_m[g] = m[g];
          red_l[g] = l[g];
        }
      }
    }
    __syncthreads();
    if (warp == 0 && writer) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= groups) break;
        float acc_o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc_o[e] = red_acc[g * head_dim + 8 * c + e];
        merge(m[g], l[g], acc[g], red_m[g], red_l[g], acc_o);
      }
    }
    __syncthreads();
  }

  if (warp == 0 && writer) {
    const size_t row0 =
        ((static_cast<size_t>(b) * num_kv + h) * splits + s) * groups;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= groups) break;
      float4* dst = reinterpret_cast<float4*>(
          acc_part + (row0 + g) * head_dim + 8 * c);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (c == 0) {
        m_part[row0 + g] = m[g];
        l_part[row0 + g] = l[g];
      }
    }
  }
}

// Pass 2: block (bh, y) combines the S partials of the G rows of
// (b, h) = bh for outputs y * kThreads .. of its G * Dh; one thread an
// output, its S loads unrolled so they are in flight together.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_attention_combine_kernel(
    const float* __restrict__ acc_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, TQ* __restrict__ out, int groups,
    int head_dim, int splits) {
  __shared__ float w_s[kMaxG][kMaxSplits];  // e^(m_s - m*)
  __shared__ float l_s[kMaxG];
  const size_t bh = blockIdx.x;  // b * num_kv + h
  const float* mp = m_part + bh * splits * groups;
  const float* lp = l_part + bh * splits * groups;
  if (threadIdx.x < groups) {
    const int g = threadIdx.x;
    float m_star = kNegInf;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, mp[s * groups + g]);
    float l = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float w = expf(mp[s * groups + g] - m_star);
      w_s[g][s] = w;
      l = fmaf(lp[s * groups + g], w, l);
    }
    l_s[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= groups * head_dim) return;
  const int g = i / head_dim;
  const float* ap = acc_part + bh * splits * groups * head_dim + i;
  const size_t stride = static_cast<size_t>(groups) * head_dim;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) a = fmaf(ap[s * stride], w_s[g][s], a);
  store(out + bh * stride + i, a / l_s[g]);
}

template <typename TKV, int TPT, int GMAX>
int launch_split(const void* q, int q_bf16, const void* k_pages,
                 const void* v_pages, const int* block_tables,
                 const int* ctx_lens, float* acc_part, float* m_part,
                 float* l_part, int batch, int num_kv, int groups,
                 int head_dim, int page_size, int max_blocks, int window,
                 int splits, int split_tile, float scale, float softcap,
                 cudaStream_t stream) {
  paged_attention_kernel<TKV, TPT, GMAX>
      <<<dim3(splits, num_kv, batch), kThreads, 0, stream>>>(
          q, q_bf16, static_cast<const TKV*>(k_pages),
          static_cast<const TKV*>(v_pages), block_tables, ctx_lens, acc_part,
          m_part, l_part, num_kv, groups, head_dim, page_size, max_blocks,
          window, split_tile, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, int GMAX>
int split_by_head_dim(int head_dim, const void* q, int q_bf16,
                      const void* k_pages, const void* v_pages,
                      const int* block_tables, const int* ctx_lens,
                      float* acc_part, float* m_part, float* l_part,
                      int batch, int num_kv, int groups, int page_size,
                      int max_blocks, int window, int splits, int split_tile,
                      float scale, float softcap, cudaStream_t s) {
#define SPLIT_CASE(TPT)                                                      \
  return launch_split<TKV, TPT, GMAX>(                                       \
      q, q_bf16, k_pages, v_pages, block_tables, ctx_lens, acc_part, m_part, \
      l_part, batch, num_kv, groups, head_dim, page_size, max_blocks,        \
      window, splits, split_tile, scale, softcap, s);
  // lanes a token: Dh / 8, rounded up to a power of two
  if (head_dim <= 32) SPLIT_CASE(4)
  if (head_dim <= 64) SPLIT_CASE(8)
  if (head_dim <= 128) SPLIT_CASE(16)
  SPLIT_CASE(32)
#undef SPLIT_CASE
}

template <typename TKV>
int split(int groups, int head_dim, const void* q, int q_bf16,
          const void* k_pages, const void* v_pages, const int* block_tables,
          const int* ctx_lens, float* acc_part, float* m_part, float* l_part,
          int batch, int num_kv, int page_size, int max_blocks, int window,
          int splits, int split_tile, float scale, float softcap,
          cudaStream_t s) {
  if (groups <= 8)
    return split_by_head_dim<TKV, 8>(
        head_dim, q, q_bf16, k_pages, v_pages, block_tables, ctx_lens,
        acc_part, m_part, l_part, batch, num_kv, groups, page_size,
        max_blocks, window, splits, split_tile, scale, softcap, s);
  return split_by_head_dim<TKV, 16>(
      head_dim, q, q_bf16, k_pages, v_pages, block_tables, ctx_lens,
      acc_part, m_part, l_part, batch, num_kv, groups, page_size, max_blocks,
      window, splits, split_tile, scale, softcap, s);
}

template <typename TQ>
int combine(const float* acc_part, const float* m_part, const float* l_part,
            void* out, int batch, int num_kv, int groups, int head_dim,
            int splits, cudaStream_t stream) {
  const dim3 grid(batch * num_kv,
                  (groups * head_dim + kThreads - 1) / kThreads);
  paged_attention_combine_kernel<TQ><<<grid, kThreads, 0, stream>>>(
      acc_part, m_part, l_part, static_cast<TQ*>(out), groups, head_dim,
      splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success).  `scratch` holds B * KV * splits * G * (Dh + 2) floats: the
// partial acc, then m, then l.  softcap <= 0 means no softcap.  The caller
// checks shapes, dtypes, devices and contiguity and picks `splits` from
// the shapes; the limits are re-checked here.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* ctx_lens, void* out, void* scratch,
    int batch, int num_kv, int groups, int head_dim, int page_size,
    int max_blocks, int window, int splits, int split_tile, float scale,
    float softcap, int q_bf16, int kv_bf16, void* stream) {
  if (groups < 1 || groups > kMaxG || head_dim < 32 || head_dim > kMaxDh ||
      head_dim % 32 != 0 || page_size < 1 || max_blocks < 1 || batch < 1 ||
      num_kv < 1 || splits < 1 || splits > kMaxSplits || split_tile < 1 ||
      num_kv > 65535 || batch > 65535 ||
      static_cast<long long>(batch) * num_kv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(batch) * num_kv * splits * groups;
  float* acc_part = static_cast<float*>(scratch);
  float* m_part = acc_part + rows * head_dim;
  float* l_part = m_part + rows;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  int err =
      kv_bf16
          ? split<__nv_bfloat16>(groups, head_dim, q, q_bf16, k_pages,
                                 v_pages, bt, cl, acc_part, m_part, l_part,
                                 batch, num_kv, page_size, max_blocks, window,
                                 splits, split_tile, scale, softcap, s)
          : split<float>(groups, head_dim, q, q_bf16, k_pages, v_pages, bt,
                         cl, acc_part, m_part, l_part, batch, num_kv,
                         page_size, max_blocks, window, splits, split_tile,
                         scale, softcap, s);
  if (err) return err;
  return q_bf16 ? combine<__nv_bfloat16>(acc_part, m_part, l_part, out, batch,
                                         num_kv, groups, head_dim, splits, s)
                : combine<float>(acc_part, m_part, l_part, out, batch, num_kv,
                                 groups, head_dim, splits, s);
}
