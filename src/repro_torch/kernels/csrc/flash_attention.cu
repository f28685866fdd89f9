// Flash-attention forward kernels for Hopper (sm_90a).
//
// Replace the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_attn_kernel, lines 26-80).  Blocked attention with an
// online softmax over the logical (B, H, L, D) views
//   q    (B, H,  Lq, D)   f32 or bf16
//   k, v (B, KV, Lk, D)   q's dtype; query head h reads kv head h / (H / KV)
//   out  (B, H,  Lq, D)   q's dtype
// each given by its base pointer and its (b, h, l) strides in elements,
// with the last dim contiguous, so the model's (B, L, H, D) tensors are
// read and written in place without a transpose copy.  Logits are
// D^-0.5 * q . k in f32, masked to j < Lk, j <= i when causal and
// i - j < window when window > 0 (window <= 0 is full attention, as in the
// TPU kernel); masked probabilities are 0; m, l and the accumulator are
// f32, and the result is acc / max(l, 1e-30), so a fully masked row gives
// 0, not NaN.
//
// Bound on the H100: operations.  A causal prefill at L = 2048 does
// 4 * D * L(L+1)/2 flops per head against ~4 * L * D * 2 bytes of q, k, v
// and out per head: ~500 flops per byte, above the bf16 ridge of ~295.
// So the products belong on the tensor cores.
//
// Two designs, picked by dtype in flash_attention_fwd:
//
// bf16 (namespace tc; every serving path): FlashAttention's structure on
// wgmma.  One block is one warpgroup (128 threads) and owns one
// (b, h, 64-row q tile); it walks 64-key kv tiles inside itself:
//   0. Q is copied once into shared memory; K and V tiles go through a
//      2-stage ring filled by cp.async (16 bytes a thread, rows past Lq or
//      Lk zero-filled), the next tile's copies in flight while the current
//      one is used.  Tiles are stored in the 128-byte swizzle that wgmma's
//      descriptors read (64 columns a row block, 8-row atoms of 1 KB);
//   1. S = Q K^T: wgmma.m64n64k16, A (Q) and B (K) from shared memory,
//      both K-major, accumulating in f32 registers;
//   2. online softmax on the accumulator fragments: S is scaled by
//      D^-0.5 log2(e) in f32 (the scale is never folded into bf16 Q), row
//      max and sum across the quad of threads that share a row by
//      shuffles, masks evaluated only on tiles that cut the diagonal, the
//      window's edge or Lk;
//   3. O += P V: P rounded to bf16 in registers is wgmma's register A
//      operand (the S accumulator layout is its fragment layout), V is B
//      read from shared memory through a transposing (MN-major)
//      descriptor, one m64n64k16 per 64 output columns and 16 keys.
// The f32 accumulator of O is D/2 registers a thread (128 at D = 256);
// with 64-key tiles nothing spills.  Shared memory: Q and two stages of
// K and V, 5 * 64 * max(D, 64) * 2 bytes (80 KB at D = 128, 160 KB at 256).
// The model's reference rounds P to v's dtype before PV as this kernel
// does; the plain version keeps PV in f32, within the bf16 gate.
//
// f32 (namespace simt; the card-vs-CPU checks only, under a 2e-5 gate that
// rules out TF32): one 8-warp block per (b, h, 64-row q tile) walks
// 32-key tiles staged as f32 in shared memory; lane t owns key t of the
// tile for QK (float4 reads, rows padded by 4 floats) and output columns
// t, t + 32, ... for PV; the tile max and sum are warp reductions.
//
// In both, kv tiles entirely above the diagonal (causal) or left of every
// row's window are never visited: the loop runs from the first tile the
// block's first row can see to the last its last row can see, so a window
// costs work proportional to the window, as the TPU kernel's @pl.when
// skips.  The heaviest (last) q tiles of a causal launch are scheduled
// first.  Each instantiation opts in to its dynamic shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -2.0e38f;

struct View {
  const void* p;
  long long sb, sh, sl;  // element strides of b, h and l
};

// ---------------------------------------------------------------------------
// f32: the SIMT kernel
// ---------------------------------------------------------------------------
namespace simt {


constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 64 query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;                     // floats of padding per k/q row

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

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 64;        // query rows a block: wgmma's M
constexpr int kBN = 64;        // keys per kv tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Byte offset of element (r, c) in a tile of `rows` bf16 rows stored as
// blocks of 64 columns (128 bytes a row) with the 128-byte swizzle: the
// 16-byte chunk k of row r sits at chunk k ^ (r % 8).  A block is `rows`
// / 8 atoms of 8 rows (1 KB) one after another.  The hardware applies the
// swizzle to address bits, so tiles start 1 KB aligned.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // at most N of this thread's copy groups in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared memory written through the generic proxy (cp.async, st.shared)
// made visible to wgmma, which reads it through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy 64 rows of D bf16 (row r at src + r * sl) into the swizzled tile
// at shared address dst; rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long sl, int valid) {
  constexpr int kRows = 64;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kRows * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + swz(r, c, kRows), ok ? src + r * sl + c : src, ok);
  }
}

// wgmma descriptor of a tile in the layout of swz() at shared address
// `addr`: layout type 1 (128-byte swizzle), 8-row groups 1 KB apart.  Both
// byte offsets are 1 KB: the 8-row group stride is the one every product
// below steps over, and the other offset (between 64-column blocks along
// the swizzled dimension) is never applied, since no instruction reads
// more than one such block.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins the registers of an accumulator at this point of the program, so
// the compiler moves no read or write of them across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x 64 f32) += a (64 x 16) b (16 x 64); a and b from shared memory,
// both K-major (trans-a = trans-b = 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64 f32) += a (64 x 16, bf16 registers) b (16 x 64); b from
// shared memory, MN-major (trans-b = 1): V's rows are keys, its columns
// the output columns
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {  // 64 rows, >= 64 columns
  return 64 * (D < 64 ? 64 : D) * 2;
}

// Q, the K and V rings (kStages tiles each), 1 KB of alignment slack
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<D>() + 1024;
}

// Accumulator fragments (wgmma m64nN, f32): thread t of the warpgroup,
// warp w = t / 32, g = (t % 32) / 4, c = t % 4, holds rows 16w + g ("a")
// and 16w + g + 8 ("b"); element 4i + e is row a (e < 2) or b, column
// 8i + 2c + (e & 1).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    View q, View k, View v, bf16* __restrict__ out, long long o_sb,
    long long o_sh, long long o_sl, int group, int q_len, int kv_len,
    int causal, int window, float scale_log2) {
  constexpr int kNB = (D < 64 ? 64 : D) / 64;  // 64-column blocks of O
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kTile;             // kStages K tiles
  const uint32_t v_s = k_s + kStages * kTile;   // kStages V tiles

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int col = 2 * (lane & 3);

  const bf16* qp = static_cast<const bf16*>(q.p) + b * q.sb + h * q.sh +
                   q0 * q.sl;
  const bf16* kp = static_cast<const bf16*>(k.p) + b * k.sb + hk * k.sh;
  const bf16* vp = static_cast<const bf16*>(v.p) + b * v.sb + hk * v.sh;

  // the kv tiles some row of this block can see
  const int q_last = min(q0 + kBM, q_len) - 1;
  const int k_hi = causal ? min(kv_len, q_last + 1) : kv_len;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_lo / kBN;
  const int t_end = (k_hi + kBN - 1) / kBN;

  float o[kNB][32];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;  // running max, log2 units
  float l_a = 0.f, l_b = 0.f;          // this thread's share of the sums

  // Q and the first kStages - 1 tiles, one copy group each (empty past
  // the range), so tile t_first + n is always group n
  if (t_first < t_end) load_tile<D>(q_s, qp, q.sl, q_len - q0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int k0 = (t_first + i) * kBN;
    if (t_first + i < t_end) {
      load_tile<D>(k_s + i * kTile, kp + k0 * k.sl, k.sl, kv_len - k0);
      load_tile<D>(v_s + i * kTile, vp + k0 * v.sl, v.sl, kv_len - k0);
    }
    cp_async_commit();
  }

  for (int t = t_first; t < t_end; ++t) {
    const int n = t - t_first;
    {  // the tile kStages - 1 ahead flies during this one
      const int ta = t + kStages - 1;
      const int k1 = ta * kBN;
      const int slot = (n + kStages - 1) % kStages;
      if (ta < t_end) {
        load_tile<D>(k_s + slot * kTile, kp + k1 * k.sl, k.sl, kv_len - k1);
        load_tile<D>(v_s + slot * kTile, vp + k1 * v.sl, v.sl, kv_len - k1);
      }
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();  // this tile (and Q) has landed here
    fence_proxy_async();
    __syncthreads();               // ... and for every thread

    const int k0 = t * kBN;
    // 1. S = Q K^T, D / 16 steps of 16 along the head dim
    const uint32_t ks = k_s + (n % kStages) * kTile;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss(s, desc(q_s + off), desc(ks + off));
    }
    wgmma_commit();
    wgmma_wait0();
    pin(s);

    // 2. online softmax in log2 units; masks only on edge tiles
    const bool edge = k0 + kBN > kv_len ||
                      (causal && k0 + kBN - 1 > q0) ||
                      (window > 0 && q0 + kBM - 1 - k0 >= window);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int r = (i & 2) ? row_b : row_a;
        const int j = k0 + 8 * (i >> 2) + col + (i & 1);
        const bool ok = j < kv_len && (!causal || j <= r) &&
                        (window <= 0 || r - j < window);
        x = ok ? x : kNegInf;
      }
      s[i] = x;
      if (i & 2)
        mx_b = fmaxf(mx_b, x);
      else
        mx_a = fmaxf(mx_a, x);
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float alpha_a = exp2f(m_a - mx_a);
    const float alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float m = (i & 2) ? m_b : m_a;
      float p = exp2f(s[i] - m);
      if (edge && s[i] == kNegInf) p = 0.f;  // masked
      s[i] = p;
      if (i & 2)
        sum_b += p;
      else
        sum_a += p;
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? alpha_b : alpha_a;

    // 3. O += P V: P in bf16 as the register A operand, 16 keys a step
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kc][r] = pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
      pin(pa[kc]);
    }
    const uint32_t vs = v_s + (n % kStages) * kTile;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) pin(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc)
        wgmma_rs(o[nb], pa[kc],
                 desc(vs + nb * (64 * 128) + kc * (16 * 128)));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) pin(o[nb]);
    __syncthreads();  // every thread is done with this stage
  }

  const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
  bf16* oa = out + b * o_sb + h * o_sh + row_a * o_sl;
  bf16* ob = out + b * o_sb + h * o_sh + row_b * o_sl;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 64 * nb + 8 * i + col;
      if (c >= D) continue;
      if (row_a < q_len)
        *reinterpret_cast<uint32_t*>(oa + c) =
            pack_bf16(o[nb][4 * i] * inv_a, o[nb][4 * i + 1] * inv_a);
      if (row_b < q_len)
        *reinterpret_cast<uint32_t*>(ob + c) =
            pack_bf16(o[nb][4 * i + 2] * inv_b, o[nb][4 * i + 3] * inv_b);
    }
}

template <int D>
int launch(View q, View k, View v, void* out, long long o_sb, long long o_sh,
           long long o_sl, int batch, int heads, int kv_heads, int q_len,
           int kv_len, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q_len + kBM - 1) / kBM, heads, batch);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, static_cast<bf16*>(out), o_sb, o_sh, o_sl, heads / kv_heads,
      q_len, kv_len, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

#define FLASH_ARGS                                                        \
  q, k, v, out, o_sb, o_sh, o_sl, batch, heads, kv_heads, q_len, kv_len, \
      causal, window, scale, s

// the head dims of the registered configs (256, 128; 64 reduced) and of the
// quickstart example (32); each is one instantiation per dtype
int dispatch(bool bf16, int head_dim, View q, View k, View v, void* out,
             long long o_sb, long long o_sh, long long o_sl, int batch,
             int heads, int kv_heads, int q_len, int kv_len, int causal,
             int window, float scale, cudaStream_t s) {
#define FLASH_CASE(D)                                                \
  case D:                                                            \
    return bf16 ? tc::launch<D>(FLASH_ARGS)                          \
                : simt::launch<float, D / 32>(FLASH_ARGS);
  switch (head_dim) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef FLASH_ARGS

}  // namespace

// Launches the kernel of q's dtype on `stream` and returns
// cudaGetLastError() (0 on success).  Strides are in elements; the last dim
// of every view is contiguous.  The caller checks devices, dtypes, shapes
// and the 16-byte alignment of every row; the limits are re-checked here.
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
  return dispatch(bf16 != 0, head_dim, qv, kv, vv, out, o_sb, o_sh, o_sl,
                  batch, heads, kv_heads, q_len, kv_len, causal, window,
                  scale, static_cast<cudaStream_t>(stream));
}
