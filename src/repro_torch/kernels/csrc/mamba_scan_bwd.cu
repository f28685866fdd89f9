// Selective-scan (Mamba S6) backward kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The reference's Pallas scan
// (repro/kernels/mamba_scan.py::mamba_scan) is forward only, and its
// training differentiates the jnp chunked associative scan
// (repro/models/ssm.py::_selective_scan_chunk).  This kernel computes the
// gradient of the function the port's forward kernel (mamba_scan.cu)
// computes, so that a training step on the card runs the scan's backward
// as one launch a Mamba layer:
//   h_t = abar_t * h_{t-1} + (delta_t * u_t) * B_t,  abar_t = exp(delta_t A)
//   y_t = h_t . C_t + D * u_t
// and, walking t from L down to 1 with g_{L+1} = 0 (per channel d, state n):
//   g_t      = dy_t C_t + abar_{t+1} g_{t+1}
//   dC_t     = sum_d dy_t h_t            dB_t = sum_d g_t delta_t u_t
//   ddelta_t = sum_n g_t (A abar_t h_{t-1} + u_t B_t)
//   du_t     = sum_n g_t delta_t B_t + D dy_t
//   dA       = sum_t g_t delta_t abar_t h_{t-1}      dD = sum_t dy_t u_t
//   u, delta, dy (B, L, D)  f32 or bf16, contiguous
//   A (D, N) f32, contiguous;  D skip (D,) f32
//   B, C (B, L, N)  u's dtype, last dim contiguous, (b, l) strides given
//   du, ddelta (B, L, D)  u's dtype
//   dA, dD as per-batch-row partials (B, D, N) and (B, D) f32; dB and dC as
//   per-block partials (B, blocks, L, 2N) f32: the caller sums each over its
//   partial axis in a fixed order.  No float atomics: the same inputs give
//   bitwise the same gradients on every call.
// Everything is computed in f32.
//
// Bound on the H100: operations.  The gradient needs abar_t for every
// state and step at least once: L * D * N exponentials at 4.18e12 a second
// (16 a clock per SM, 132 SMs, 1.98 GHz).  At jamba's shape (B 1, L 2048,
// D 16384, N 16) that is 537 M exps, 0.128 ms, against 0.34 GB of inputs
// and outputs in bf16 (u, delta, dy read, du, ddelta written, 67 MB each;
// A, B, C, D and the f32 dA), 0.10 ms at 3.35 TB/s.  This design takes two
// exponentials a state-step (the forward sweep and the recomputation), so
// its own floor is 0.26 ms.
//
// Design: simple first.  One lane owns one state (b, d, n); a block of
// kThreads lanes owns kThreads / N neighbouring channels of one batch row,
// and walks time in lock-step, kChunk steps at a time.
//   1. Staging.  A chunk's inputs (u, delta, dy of the block's channels; B
//      and C) are loaded by the whole block as coalesced rows into a
//      shared-memory stage, widened to f32, two stages in turn; each thread
//      loads its few elements of the NEXT chunk into registers while the
//      block computes this one.  The lanes then read their inputs from the
//      stage (a channel's lanes read one address, a broadcast).  A first
//      design loaded them lane by lane from device memory inside the
//      reverse walk: 8.7 ms at jamba's shape, its loads waiting in line.
//   2. Forward sweep.  Each lane runs the recurrence over L and stores its
//      state before every chunk into a scratch buffer (B, L / kChunk, D, N)
//      f32 (134 MB at jamba's shape), its own slots only.  The last chunk
//      is not swept.
//   3. Reverse sweep, a chunk at a time from the last: the lane rebuilds the
//      chunk's kChunk states in registers from its checkpoint, then walks
//      them backwards carrying g.  The rebuild rounds as the forward kernel
//      and the plain version do (the exact expf; dt * u, abar * h and
//      du * B as separate products; their sum), so the rebuilt states are
//      bitwise the forward's.
//   4. Reductions, once a chunk, through shared memory.  Each lane writes
//      its terms of ddelta, du, dB and dC for the chunk's steps to four
//      buffers [kChunk][channels][N + 1] (padded: the sums read them
//      without bank conflicts); after a barrier each thread sums one
//      (step, channel)'s N terms of ddelta and du in order and writes them
//      as a coalesced row, and one (step, j)'s terms of dB or dC over the
//      block's channels in order into the block's partial row.  dA and dD
//      stay in registers over the whole walk.
//   Registers: 512 lanes a block cap a lane at 128.  N = 8 and 16 (every
//   config's ssm_state_dim) build without spills; N = 4, the reference's
//   sweep only (128 channels a block, 13 staged elements a lane), spills
//   744 bytes an instance.
//   Steps past L are staged as zeros (dt = u = B = C = dy = 0): abar = 1
//   and no term changes g, h, dA or dD; their rows are not written.
//   Channels past D are staged as zeros too and write nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // lanes a block, one state each
constexpr int kChunk = 16;     // steps between checkpoints

template <int N>
struct Map {
  static constexpr int kChannels = kThreads / N;    // channels a block
  static constexpr int kRow = kChannels * (N + 1);  // a step's padded row
  static constexpr int kCol = kChunk * kChannels;   // one (step, channel) array
  static constexpr int kNs = kChunk * N;            // one (step, state) array
  // a stage: u, delta, dy [kChunk][kChannels], then B, C [kChunk][N]
  static constexpr int kStage = 3 * kCol + 2 * kNs;
  static constexpr int kStage1 = 2 * kCol + kNs;  // the forward's: u, delta, B
  static constexpr int kLoads = (kStage + kThreads - 1) / kThreads;
  static_assert(kThreads % N == 0 && N <= 32, "states a block");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The forward's state update, rounded as mamba_scan.cu and the plain
// version round it.
__device__ __forceinline__ float step_state(float h, float abar, float dt,
                                            float ut, float bt) {
  return __fadd_rn(__fmul_rn(abar, h), __fmul_rn(__fmul_rn(dt, ut), bt));
}

// Where a block reads: its batch row's u, delta and dy at its first
// channel, and its B and C rows.
template <typename T>
struct Src {
  const T* u;
  const T* dt;
  const T* gy;
  const T* b;
  const T* c;
  long long ld, b_sl, c_sl;
  int length, cols;  // steps, and the block's channels inside D
};

// Element e of chunk t0's stage, as f32 (0 past L or past D).
template <typename T, int N>
__device__ __forceinline__ float fetch(const Src<T>& s, int t0, int e) {
  using M = Map<N>;
  constexpr int C = M::kChannels;
  if (e < 3 * M::kCol) {
    const int which = e / M::kCol, r = e % M::kCol;
    const int i = r / C, c = r % C;
    if (t0 + i >= s.length || c >= s.cols) return 0.f;
    const T* base = which == 0 ? s.u : which == 1 ? s.dt : s.gy;
    return to_f32(base[static_cast<long long>(t0 + i) * s.ld + c]);
  }
  const int r = e - 3 * M::kCol;
  const int which = r / M::kNs, i = r % M::kNs / N, n = r % N;
  if (t0 + i >= s.length) return 0.f;
  return which == 0 ? to_f32(s.b[static_cast<long long>(t0 + i) * s.b_sl + n])
                    : to_f32(s.c[static_cast<long long>(t0 + i) * s.c_sl + n]);
}

// This thread's elements of chunk t0's stage into registers; the forward
// sweep (kAll false) needs u, delta and B only.
template <typename T, int N, bool kAll>
__device__ __forceinline__ void prefetch(float (&r)[Map<N>::kLoads],
                                         const Src<T>& s, int t0, int tid) {
  using M = Map<N>;
#pragma unroll
  for (int j = 0; j < M::kLoads; ++j) {
    int e = tid + j * kThreads;
    if (!kAll && e >= 2 * M::kCol) e += M::kCol;  // skip dy
    const bool in = kAll ? e < M::kStage : e < M::kStage1 + M::kCol;
    r[j] = in ? fetch<T, N>(s, t0, e) : 0.f;
  }
}

template <int N, bool kAll>
__device__ __forceinline__ void place(float* stage,
                                      const float (&r)[Map<N>::kLoads],
                                      int tid) {
  using M = Map<N>;
#pragma unroll
  for (int j = 0; j < M::kLoads; ++j) {
    int e = tid + j * kThreads;
    if (!kAll && e >= 2 * M::kCol) e += M::kCol;
    if (kAll ? e < M::kStage : e < M::kStage1 + M::kCol) stage[e] = r[j];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
    mamba_scan_bwd_kernel(const T* __restrict__ u,
                          const T* __restrict__ delta,
                          const float* __restrict__ a,
                          const T* __restrict__ bmat,
                          const T* __restrict__ cmat,
                          const float* __restrict__ dskip,
                          const T* __restrict__ dy, T* __restrict__ du,
                          T* __restrict__ ddelta,
                          float* __restrict__ da_part,
                          float* __restrict__ dd_part,
                          float* __restrict__ bc_part,
                          float* __restrict__ ckpt, int length, int dim,
                          long long b_sb, long long b_sl, long long c_sb,
                          long long c_sl, int nblk) {
  using M = Map<N>;
  constexpr int C = M::kChannels;
  extern __shared__ __align__(16) float smem[];
  float* s_dl = smem;                     // ddelta terms
  float* s_du = s_dl + kChunk * M::kRow;  // du terms
  float* s_db = s_du + kChunk * M::kRow;  // dB terms
  float* s_dc = s_db + kChunk * M::kRow;  // dC terms
  float* stages = s_dc + kChunk * M::kRow;  // two stages of M::kStage

  const int tid = threadIdx.x;
  const int ch = tid / N, n = tid % N;
  const int d0 = blockIdx.x * C;
  const int d = d0 + ch;
  const bool live = d < dim;
  const int bi = blockIdx.y;
  const long long ld = dim;
  const long long row0 = static_cast<long long>(bi) * length * ld;
  const Src<T> src = {u + row0 + d0, delta + row0 + d0, dy + row0 + d0,
                      bmat + bi * b_sb, cmat + bi * c_sb, ld, b_sl, c_sl,
                      length, min(C, dim - d0)};
  const long long dl = live ? d : 0;  // a lane past D reads nothing
  const float an = live ? a[dl * N + n] : 0.f;
  const float dsk = live && n == 0 ? dskip[dl] : 0.f;  // D dy once a channel
  const int chunks = (length + kChunk - 1) / kChunk;
  const long long kstride = ld * N;  // one chunk's checkpoints
  float* kp = ckpt + static_cast<long long>(bi) * chunks * kstride + dl * N
              + n;
  const int at = ch * (N + 1) + n;  // this lane's slot in a buffer row
  float pre[M::kLoads];

  // 2. the forward sweep: the state before each chunk but the last
  float h = 0.f;
  if (chunks > 1) prefetch<T, N, false>(pre, src, 0, tid);
#pragma unroll 1
  for (int k = 0; k + 1 < chunks; ++k) {
    float* st = stages + (k & 1) * M::kStage;
    place<N, false>(st, pre, tid);
    __syncthreads();  // the stage is whole; the other one is free
    if (k + 2 < chunks) prefetch<T, N, false>(pre, src, (k + 1) * kChunk, tid);
    if (live) kp[k * kstride] = h;
    const float* su = st;
    const float* sd = st + M::kCol;
    const float* sb = st + 3 * M::kCol;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dt = sd[i * C + ch];
      h = step_state(h, expf(__fmul_rn(dt, an)), dt, su[i * C + ch],
                     sb[i * N + n]);
    }
  }
  if (live) kp[(chunks - 1) * kstride] = h;

  // 3. the reverse sweep
  float g = 0.f;  // abar_{t+1} g_{t+1}
  float da_acc = 0.f, dd_acc = 0.f;
  prefetch<T, N, true>(pre, src, (chunks - 1) * kChunk, tid);
#pragma unroll 1
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int rows = min(kChunk, length - t0);
    float* st = stages + (k & 1) * M::kStage;
    place<N, true>(st, pre, tid);
    __syncthreads();  // the stage is whole; the last chunk's sums are done
    if (k > 0) prefetch<T, N, true>(pre, src, t0 - kChunk, tid);
    const float* su = st;
    const float* sd = st + M::kCol;
    const float* sg = st + 2 * M::kCol;
    const float* sb = st + 3 * M::kCol;
    const float* sc = sb + M::kNs;
    float hp[kChunk], ab[kChunk];  // h_{t-1} and abar_t of the chunk
    float hc = live ? kp[k * kstride] : 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dt = sd[i * C + ch];
      ab[i] = expf(__fmul_rn(dt, an));
      hp[i] = hc;
      hc = step_state(hc, ab[i], dt, su[i * C + ch], sb[i * N + n]);
    }
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      const float dt = sd[i * C + ch], ut = su[i * C + ch];
      const float gy = sg[i * C + ch];
      const float bt = sb[i * N + n], ct = sc[i * N + n];
      const float ht = i + 1 < kChunk ? hp[i + 1] : hc;  // h_t
      const float gt = fmaf(gy, ct, g);                   // g_t
      const float decay = ab[i] * hp[i];                  // abar_t h_{t-1}
      const int slot = i * M::kRow + at;
      s_dc[slot] = gy * ht;
      s_db[slot] = gt * (dt * ut);
      s_dl[slot] = gt * fmaf(an, decay, ut * bt);
      s_du[slot] = fmaf(dsk, gy, gt * bt * dt);
      da_acc = fmaf(gt * dt, decay, da_acc);
      dd_acc = fmaf(gy, ut, dd_acc);
      g = ab[i] * gt;
    }
    __syncthreads();
    // ddelta and du: a (step, channel) a thread, its N terms in order
    for (int o = tid; o < kChunk * C; o += kThreads) {
      const int i = o / C, c = o % C;
      if (i < rows && d0 + c < dim) {
        const float* p1 = s_dl + i * M::kRow + c * (N + 1);
        const float* p2 = s_du + i * M::kRow + c * (N + 1);
        float s1 = p1[0], s2 = p2[0];
#pragma unroll
        for (int q = 1; q < N; ++q) {
          s1 += p1[q];
          s2 += p2[q];
        }
        const long long off = row0 + (t0 + i) * ld + d0 + c;
        put(ddelta + off, s1);
        put(du + off, s2);
      }
    }
    // dB and dC: a (step, j) a thread, the block's channels in order
    for (int o = tid; o < kChunk * 2 * N; o += kThreads) {
      const int i = o / (2 * N), j = o % (2 * N);
      if (i < rows) {
        const float* p = (j < N ? s_db : s_dc) + i * M::kRow + j % N;
        float s = p[0];
        for (int c = 1; c < C; ++c) s += p[c * (N + 1)];
        bc_part[((static_cast<long long>(bi) * nblk + blockIdx.x) * length
                 + t0 + i) * 2 * N + j] = s;
      }
    }
  }
  if (live) {
    da_part[(static_cast<long long>(bi) * ld + d) * N + n] = da_acc;
    if (n == 0) dd_part[static_cast<long long>(bi) * ld + d] = dd_acc;
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* a, const void* b,
           const void* c, const float* dskip, const void* dy, void* du,
           void* ddelta, float* da_part, float* dd_part, float* bc_part,
           float* ckpt, int batch, int length, int dim, long long b_sb,
           long long b_sl, long long c_sb, long long c_sl, long long blocks,
           long long chunks, cudaStream_t stream) {
  using M = Map<N>;
  const long long want = (dim + M::kChannels - 1) / M::kChannels;
  if (blocks != want || blocks > 0x7fffffff
      || chunks != (length + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (4 * kChunk * M::kRow + 2 * M::kStage)
                   * static_cast<int>(sizeof(float));
  auto kernel = mamba_scan_bwd_kernel<T, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(b), static_cast<const T*>(c), dskip,
      static_cast<const T*>(dy), static_cast<T*>(du), static_cast<T*>(ddelta),
      da_part, dd_part, bc_part, ckpt, length, dim, b_sb, b_sl, c_sb, c_sl,
      static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int state, const void* u, const void* delta, const float* a,
             const void* b, const void* c, const float* dskip, const void* dy,
             void* du, void* ddelta, float* da_part, float* dd_part,
             float* bc_part, float* ckpt, int batch, int length, int dim,
             long long b_sb, long long b_sl, long long c_sb, long long c_sl,
             long long blocks, long long chunks, cudaStream_t s) {
#define BWD_CASE(NS)                                                         \
  case NS:                                                                   \
    return launch<T, NS>(u, delta, a, b, c, dskip, dy, du, ddelta, da_part,  \
                         dd_part, bc_part, ckpt, batch, length, dim, b_sb,   \
                         b_sl, c_sb, c_sl, blocks, chunks, s);
  // the forward kernel's state sizes: the reference's sweep and the
  // configs' ssm_state_dim (16)
  switch (state) {
    BWD_CASE(4)
    BWD_CASE(8)
    BWD_CASE(16)
  }
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Strides are in elements; `blocks` is the partial rows bc_part
// holds and `chunks` the checkpoints ckpt holds a batch row ((B, chunks, D,
// N) f32), which must be the kernel's own counts (kThreads / N channels a
// block, one checkpoint every kChunk steps).  The caller checks devices,
// dtypes, shapes and contiguity and sizes the partials and the checkpoint
// scratch; the limits are re-checked here.
extern "C" int mamba_scan_bwd(const void* u, const void* delta, const void* a,
                              const void* b, const void* c, const void* dskip,
                              const void* dy, void* du, void* ddelta,
                              void* da_part, void* dd_part, void* bc_part,
                              void* ckpt, int batch, int length, int dim,
                              int state, long long b_sb, long long b_sl,
                              long long c_sb, long long c_sl, int bf16,
                              long long blocks, long long chunks,
                              void* stream) {
  if (batch < 1 || batch > 65535 || length < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  float* dap = static_cast<float*>(da_part);
  float* ddp = static_cast<float*>(dd_part);
  float* bcp = static_cast<float*>(bc_part);
  float* kp = static_cast<float*>(ckpt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(state, u, delta, af, b, c, df, dy, du,
                                   ddelta, dap, ddp, bcp, kp, batch, length,
                                   dim, b_sb, b_sl, c_sb, c_sl, blocks,
                                   chunks, s);
  return dispatch<float>(state, u, delta, af, b, c, df, dy, du, ddelta, dap,
                         ddp, bcp, kp, batch, length, dim, b_sb, b_sl, c_sb,
                         c_sl, blocks, chunks, s);
}
