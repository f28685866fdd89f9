// Selective-scan (Mamba S6) forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (_scan_kernel, lines 29-47).  The discretisation is fused with the
// recurrence and the C projection, so the (B, L, D, N) discretised tensors
// never reach device memory:
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t    (per d, n)
//   y_t = h_t . C_t + D * u_t
//   u, delta (B, L, D)  f32 or bf16, contiguous
//   A        (D, N)     f32, contiguous
//   B, C     (B, L, N)  u's dtype, last dim contiguous, (b, l) strides given
//   D skip   (D,)       f32
//   y        (B, L, D)  u's dtype;  h_last (B, D, N) f32
// Everything is computed in f32, as the TPU kernel casts its loads.
//
// Bound on the H100: operations.  The scan takes L * D * N exponentials; the
// special-function units give 16 per clock per SM (CUDA C++ Programming
// Guide, arithmetic-instruction throughput, compute capability 9.0), 4.2e12
// a second on 132 SMs at 1.98 GHz.  At jamba's prefill shape (B 1, L 2048,
// D 16384, N 16) that is 537 M exps, 0.13 ms, against 203 MB of u, delta, y,
// A, B, C, D and h_last, 0.061 ms at 3.35 TB/s.
//
// Design (simple and right first).  The TPU kernel gives each grid cell a
// (d_block, N) state tile in VMEM and walks time with fori_loop.  Here a
// group of N / 4 neighbouring lanes owns one (b, d) channel, each lane 4 of
// its N states and their 4 values of A, in registers; a block of 128
// threads walks time in tiles of kTile steps:
//   * one thread per channel would be only 16384 threads at jamba's shape,
//     a single warp per scheduler, with nothing to hide the latency of
//     each step's exponentials; 4 lanes per channel give 16 warps an SM;
//   * the tile's u and delta are read into registers (the lanes of a
//     channel read the same element), and the next tile's loads are issued
//     before this tile is computed, so memory latency hides behind a tile
//     of exponentials;
//   * the tile's B_t and C_t, shared by every channel of the batch row, are
//     read into registers at the same time and staged in shared memory
//     (double-buffered, one barrier per tile) after the tile is computed;
//   * y_t is each lane's 4-term dot product, summed over the channel's
//     lanes with butterfly shuffles, plus D * u_t;
//   * exp(delta * A) is expf of the same f32 product the plain version
//     forms, and the state update is rounded as the plain version rounds
//     it (a product, a product, a sum: no FMA contraction), so h follows
//     the plain version step for step.  Over L steps of a channel whose
//     A is near 0 nothing decays, and a less exact exponential (exp2f of
//     a prescaled argument) drifts from it by more than the f32
//     tolerance at L = 2048.
// Channels past D (no block size divides every D) take part in the staging,
// the shuffles and the barriers but read and write nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kStates = 4;     // states per thread
constexpr int kTile = 8;       // time steps per tile

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// values of a tile's B (and of its C) each thread stages
template <int N>
constexpr int kPerThread = (kTile * N + kThreads - 1) / kThreads;

// Issue the loads of the tile that starts at t0: u and delta of this
// thread's channel and its share of the tile's B and C.  Out-of-range
// steps and dead channels read 0.
template <typename T, int N>
__device__ __forceinline__ void fetch(
    int t0, int length, long long dim, bool live, const T* up, const T* dp,
    const T* bp, long long b_sl, const T* cp, long long c_sl,
    float (&fu)[kTile], float (&fd)[kTile], float (&fb)[kPerThread<N>],
    float (&fc)[kPerThread<N>]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int t = t0 + i;
    const bool ok = live && t < length;
    fu[i] = ok ? load(up + t * dim) : 0.f;
    fd[i] = ok ? load(dp + t * dim) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread<N>; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int t = t0 + idx / N;
    const bool ok = idx < kTile * N && t < length;
    fb[j] = ok ? load(bp + t * b_sl + idx % N) : 0.f;
    fc[j] = ok ? load(cp + t * c_sl + idx % N) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void stage(float (&sb)[kTile][N],
                                      float (&sc)[kTile][N],
                                      const float (&fb)[kPerThread<N>],
                                      const float (&fc)[kPerThread<N>]) {
#pragma unroll
  for (int j = 0; j < kPerThread<N>; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (idx < kTile * N) {
      sb[idx / N][idx % N] = fb[j];
      sc[idx / N][idx % N] = fc[j];
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ a, const T* __restrict__ bmat,
    const T* __restrict__ cmat, const float* __restrict__ dskip,
    T* __restrict__ y, float* __restrict__ hlast, int length, int dim,
    long long b_sb, long long b_sl, long long c_sb, long long c_sl) {
  constexpr int kLanes = N / kStates;  // lanes per channel: 1, 2 or 4
  constexpr int kBC = kPerThread<N>;
  __shared__ __align__(16) float s_b[2][kTile][N];
  __shared__ __align__(16) float s_c[2][kTile][N];

  const int bi = blockIdx.y;
  const int d = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int n0 = (threadIdx.x % kLanes) * kStates;  // this lane's states
  const bool live = d < dim;
  const long long ld = dim;
  const long long base = static_cast<long long>(bi) * length * ld + d;
  const T* up = u + base;
  const T* dp = delta + base;
  T* yp = y + base;
  const T* bp = bmat + bi * b_sb;
  const T* cp = cmat + bi * c_sb;
  const bool writer = live && n0 == 0;

  float ar[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    ar[k] = live ? a[static_cast<long long>(d) * N + n0 + k] : 0.f;
    h[k] = 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;

  float cu[kTile], cd[kTile], rb[kBC], rc[kBC];
  fetch<T, N>(0, length, ld, live, up, dp, bp, b_sl, cp, c_sl, cu, cd, rb,
              rc);
  stage<N>(s_b[0], s_c[0], rb, rc);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < length; t0 += kTile, buf ^= 1) {
    const int t1 = t0 + kTile;
    float nu[kTile], nd[kTile];
    if (t1 < length)  // in flight while this tile is computed
      fetch<T, N>(t1, length, ld, live, up, dp, bp, b_sl, cp, c_sl, nu, nd,
                  rb, rc);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int t = t0 + i;
      if (t >= length) break;  // the same for the whole block
      const float dt = cd[i];
      const float ut = cu[i];
      const float du = __fmul_rn(dt, ut);
      // this lane's 4 values of B_t and C_t: one 16-byte read each
      const float4 b4 = *reinterpret_cast<const float4*>(&s_b[buf][i][n0]);
      const float4 c4 = *reinterpret_cast<const float4*>(&s_c[buf][i][n0]);
      const float bt[kStates] = {b4.x, b4.y, b4.z, b4.w};
      const float ct[kStates] = {c4.x, c4.y, c4.z, c4.w};
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float abar = expf(__fmul_rn(dt, ar[k]));
        h[k] = __fadd_rn(__fmul_rn(abar, h[k]), __fmul_rn(du, bt[k]));
        acc = fmaf(h[k], ct[k], acc);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (writer) store(yp + t * ld, __fadd_rn(acc, __fmul_rn(dsk, ut)));
    }
    if (t1 < length) stage<N>(s_b[buf ^ 1], s_c[buf ^ 1], rb, rc);
    // buf ^ 1 is complete, and every thread is done with buf before the
    // tile after next overwrites it
    __syncthreads();
    if (t1 < length) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        cu[i] = nu[i];
        cd[i] = nd[i];
      }
    }
  }
  if (live) {
    float* hp = hlast + (static_cast<long long>(bi) * ld + d) * N + n0;
#pragma unroll
    for (int k = 0; k < kStates; ++k) hp[k] = h[k];
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* a, const void* b,
           const void* c, const float* dskip, void* y, float* hlast,
           int batch, int length, int dim, long long b_sb, long long b_sl,
           long long c_sb, long long c_sl, cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N / kStates);  // per block
  const dim3 grid((dim + kChannels - 1) / kChannels, batch);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(b), static_cast<const T*>(c), dskip,
      static_cast<T*>(y), hlast, length, dim, b_sb, b_sl, c_sb, c_sl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int state, const void* u, const void* delta, const float* a,
             const void* b, const void* c, const float* dskip, void* y,
             float* hlast, int batch, int length, int dim, long long b_sb,
             long long b_sl, long long c_sb, long long c_sl,
             cudaStream_t s) {
#define SCAN_CASE(NS)                                                       \
  case NS:                                                                  \
    return launch<T, NS>(u, delta, a, b, c, dskip, y, hlast, batch, length, \
                         dim, b_sb, b_sl, c_sb, c_sl, s);
  // the reference's sweep (4, 8, 16) and the configs' ssm_state_dim (16)
  switch (state) {
    SCAN_CASE(4)
    SCAN_CASE(8)
    SCAN_CASE(16)
  }
#undef SCAN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  Strides are in elements.  The caller checks devices, dtypes,
// shapes and contiguity; the limits are re-checked here.
extern "C" int mamba_scan_fwd(const void* u, const void* delta,
                              const void* a, const void* b, const void* c,
                              const void* dskip, void* y, void* hlast,
                              int batch, int length, int dim, int state,
                              long long b_sb, long long b_sl, long long c_sb,
                              long long c_sl, int bf16, void* stream) {
  if (batch < 1 || batch > 65535 || length < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  float* hf = static_cast<float*>(hlast);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(state, u, delta, af, b, c, df, y, hf,
                                   batch, length, dim, b_sb, b_sl, c_sb, c_sl,
                                   s);
  return dispatch<float>(state, u, delta, af, b, c, df, y, hf, batch, length,
                         dim, b_sb, b_sl, c_sb, c_sl, s);
}
