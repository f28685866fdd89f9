// Flash-attention forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_attn_kernel, lines 26-80).  Blocked attention with an
// online softmax over the logical (B, H, L, D) views
//   q    (B, H,  Lq, D)   f32 or bf16
//   k, v (B, KV, Lk, D)   q's dtype; query head h reads kv head h / (H / KV)
//   out  (B, H,  Lq, D)   q's dtype
// each given by its base pointer and its (b, h, l) strides in elements,
// with the last dim contiguous, so the model's (B, L, H, D) tensors are
// read and written in place without a transpose copy.  Logits are
// (q * D^-0.5) . k in f32, masked to j < Lk, j <= i when causal and
// i - j < window when window > 0 (window <= 0 is full attention, as in the
// TPU kernel); masked scores are -2e38 and their probabilities are set to
// 0 explicitly; m, l and the accumulator are f32, and the result is
// acc / max(l, 1e-30), so a fully masked row gives 0, not NaN.
//
// Bound on the H100: operations.  A causal prefill at L = 2048 does
// 4 * D * L(L+1)/2 flops per head against ~4 * L * D * 2 bytes of q, k, v
// and out per head: ~500 flops per byte, above the bf16 ridge of ~295.
//
// Design (a simple SIMT kernel; tensor cores, wgmma and TMA are later
// work).  The TPU kernel walks a sequential kv grid axis with its
// accumulators in VMEM; here one thread block of 8 warps owns one
// (b, h, 64-row q tile) and loops over 32-key kv tiles inside the block:
//   0. the q tile (scaled) is staged once in shared memory as f32; each kv
//      tile's k and v rows are staged as f32 (bf16 inputs are widened on
//      the load), rows past Lk as zeros, so tails need no padding copy;
//   1. warp w owns q rows 8w .. 8w + 7, lane t owns key t of the tile:
//      lane t forms the 8 dot products of key t with float4 reads of its
//      k row (conflict-free: rows are padded by 4 floats) and broadcast
//      reads of the q rows;
//   2. mask, then the online softmax: the tile max and sum of each row are
//      warp reductions; p goes to shared memory;
//   3. PV: lane t owns output columns t, t + 32, ...: acc[r][c] += p . v,
//      with p read as float4 broadcasts and v rows read coalesced.
// Kv tiles entirely above the diagonal (causal) or left of every row's
// window are never visited: the loop runs from the first tile the block's
// first row can see to the last its last row can see, so a window costs
// work proportional to the window, as the TPU kernel's @pl.when skips.
// The heaviest (last) q tiles of a causal launch are scheduled first.
// Shared memory is 73.5 KB at D = 128 and 137.5 KB at D = 256, above the
// 48 KB default, so each instantiation opts in to its size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;                     // floats of padding per k/q row
constexpr float kNegInf = -2.0e38f;

struct View {
  const void* p;
  long long sb, sh, sl;  // element strides of b, h and l
};

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

// Copy `rows` rows of D elements (row r at src + r * sl) into shared
// memory as f32 rows of `ld` floats, times `scale`; rows at or past
// `valid` are zero.  16-byte loads; the wrapper checks the alignment.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long sl, int rows, int valid,
                                      float scale) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kPer;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    float* d = dst + r * ld + c * kPer;
    if (r >= valid) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) d[e] = 0.f;
      continue;
    }
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * sl + c * kPer);
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(&u);
      *reinterpret_cast<float4*>(d) =
          make_float4(f.x * scale, f.y * scale, f.z * scale, f.w * scale);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 a = __bfloat1622float2(h[2 * j]);
        const float2 b = __bfloat1622float2(h[2 * j + 1]);
        *reinterpret_cast<float4*>(d + 4 * j) =
            make_float4(a.x * scale, a.y * scale, b.x * scale, b.y * scale);
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    View q, View k, View v, T* __restrict__ out, long long o_sb,
    long long o_sh, long long o_sl, int heads, int group, int q_len,
    int kv_len, int causal, int window, float scale) {
  constexpr int D = 32 * NC;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // kBQ x LD
  float* k_s = q_s + kBQ * LD;       // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x D
  float* p_s = v_s + kBK * D;        // kBQ x kBK

  // heaviest causal tiles first: block 0 takes the last q tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qp = static_cast<const T*>(q.p) + b * q.sb + h * q.sh + q0 * q.sl;
  const T* kp = static_cast<const T*>(k.p) + b * k.sb + hk * k.sh;
  const T* vp = static_cast<const T*>(v.p) + b * v.sb + hk * v.sh;
  stage<T, D>(q_s, LD, qp, q.sl, kBQ, q_len - q0, scale);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // the kv range some row of this tile can see
  const int q_last = min(q0 + kBQ, q_len) - 1;
  const int k_hi = causal ? min(kv_len, q_last + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done (and q_s is full)
    stage<T, D>(k_s, LD, kp + k0 * k.sl, k.sl, kBK, kv_len - k0, 1.f);
    stage<T, D>(v_s, D, vp + k0 * v.sl, v.sl, kBK, kv_len - k0, 1.f);
    __syncthreads();

    // 1. logits of key `lane` against this warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + lane * LD);
#pragma unroll 4
    for (int i = 0; i < D / 4; ++i) {
      const float4 kv4 = k4[i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        // the same address in every lane: a broadcast
        const float4 qv =
            reinterpret_cast<const float4*>(q_s + (row0 + r) * LD)[i];
        s[r] = fmaf(qv.x, kv4.x, s[r]);
        s[r] = fmaf(qv.y, kv4.y, s[r]);
        s[r] = fmaf(qv.z, kv4.z, s[r]);
        s[r] = fmaf(qv.w, kv4.w, s[r]);
      }
    }

    // 2. mask and online softmax, one row at a time across the warp
    const int kj = k0 + lane;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      const bool ok = kj < kv_len && (!causal || kj <= qi) &&
                      (window <= 0 || qi - kj < window);
      const float x = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      alpha[r] = expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + warp_sum(p);
      m[r] = m_new;
      p_s[(row0 + r) * kBK + lane] = p;
    }
    __syncwarp();

    // 3. acc = alpha * acc + p @ v on columns lane + 32c
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha[r];
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[t][c] = v_s[(j + t) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + (row0 + r) * kBK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float a = acc[r][c];
          a = fmaf(p4.x, vv[0][c], a);
          a = fmaf(p4.y, vv[1][c], a);
          a = fmaf(p4.z, vv[2][c], a);
          a = fmaf(p4.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();  // p_s is read before the next tile's writes
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= q_len) continue;
    T* o = out + b * o_sb + h * o_sh + qi * o_sl;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + lane + 32 * c, acc[r][c] / denom);
  }
}

template <int NC>
constexpr int smem_bytes() {
  return (kBQ * (32 * NC + kPad) + kBK * (32 * NC + kPad) + kBK * 32 * NC +
          kBQ * kBK) *
         4;
}

template <typename T, int NC>
int launch(View q, View k, View v, void* out, long long o_sb, long long o_sh,
           long long o_sl, int batch, int heads, int kv_heads, int q_len,
           int kv_len, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q_len + kBQ - 1) / kBQ, heads, batch);
  flash_attention_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      q, k, v, static_cast<T*>(out), o_sb, o_sh, o_sl, heads,
      heads / kv_heads, q_len, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, View q, View k, View v, void* out, long long o_sb,
             long long o_sh, long long o_sl, int batch, int heads,
             int kv_heads, int q_len, int kv_len, int causal, int window,
             float scale, cudaStream_t s) {
#define FLASH_CASE(NC)                                                       \
  case NC:                                                                   \
    return launch<T, NC>(q, k, v, out, o_sb, o_sh, o_sl, batch, heads,       \
                         kv_heads, q_len, kv_len, causal, window, scale, s);
  // the head dims of the registered configs (256, 128; 64 reduced) and of
  // the quickstart example (32); each is one instantiation per dtype
  switch (head_dim / 32) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(4)
    FLASH_CASE(8)
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Strides are in elements; the last dim of every view is
// contiguous.  The caller checks devices, dtypes, shapes and the 16-byte
// alignment of every row; the limits are re-checked here.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int q_len, int kv_len, int head_dim,
    long long q_sb, long long q_sh, long long q_sl, long long k_sb,
    long long k_sh, long long k_sl, long long v_sb, long long v_sh,
    long long v_sl, long long o_sb, long long o_sh, long long o_sl,
    int causal, int window, float scale, int bf16, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      q_len < 1 || kv_len < 1 || head_dim % 32 != 0 || heads > 65535 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const View qv{q, q_sb, q_sh, q_sl};
  const View kv{k, k_sb, k_sh, k_sl};
  const View vv{v, v_sb, v_sh, v_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(head_dim, qv, kv, vv, out, o_sb, o_sh,
                                   o_sl, batch, heads, kv_heads, q_len,
                                   kv_len, causal, window, scale, s);
  return dispatch<float>(head_dim, qv, kv, vv, out, o_sb, o_sh, o_sl, batch,
                         heads, kv_heads, q_len, kv_len, causal, window,
                         scale, s);
}
