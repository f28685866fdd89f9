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
// A, B, C, D and h_last, 0.061 ms at 3.35 TB/s.  With the exact `expf` a
// state-step costs ~13 instructions (the product dt * a, ~8 for expf, two
// products and a sum, the FFMA of y; 15.7 in the built loop with its
// staging and y), so instruction issue, 4 warp instructions a clock per
// SM, bounds this design near 0.21-0.26 ms.
//
// Design.  The TPU kernel gives each grid cell a (d_block, N) state tile in
// VMEM and walks time with fori_loop.  Here a group of N / kStates
// neighbouring lanes owns one (b, d) channel, each lane kStates of its
// states and their values of A, in registers; every warp is a pipeline of
// its own (no barrier spans warps):
//   1. Rounding.  For each state and step the kernel forms
//        du = dt * u,  abar = expf(dt * a),  h = abar * h + du * b
//      with __fmul_rn / __fadd_rn (a product, a product, a sum: no FMA
//      contraction) and the exact expf, which is what the plain version
//      computes, so h_last is bitwise the plain version's on the card.
//      Over L steps of a channel whose A is near 0 nothing decays, and a
//      less exact exponential (exp2f of a prescaled argument) drifted from
//      it by more than the f32 tolerance at L = 2048.  Only the order of
//      y's sum over n differs.
//   2. No branch and no store in the tile.  Steps past L are staged as
//      dt = 0, u = -0, B = C = 0: expf(0) = 1 and 1 * h = h, du * b = -0
//      and h + -0 = h for every h, so they leave h bitwise unchanged; only
//      the y store is masked.  The exponentials of a tile do not depend on
//      h; with no exit and no shared-memory store in the unrolled tile
//      (its y terms stay in registers until its last step), the compiler
//      runs the next steps' loads and exponentials beside this step's
//      recurrence.  A store of each step's terms kept every step behind
//      the one before (0.398 against 0.358 ms, PERF.md).
//   3. A ring of kStages tiles in shared memory per warp.  A tile is kTile
//      steps of u and delta for the warp's channels and of B and C, filled
//      by cp.async in 16-byte pieces and waited for with cp.async.wait_group
//      and __syncwarp (scan_staging.cuh, shared with the backward kernel):
//      no block barrier, no register prefetch.  The lanes of a channel
//      read u and delta from shared memory as a broadcast; a bf16 tile's B
//      and C are widened to f32 once a tile, not in every lane.  Where a pointer, stride or row is not a multiple of 16 bytes
//      (B/C slices of N = 4, a ragged D), the same kernel stages 8-, 4- or
//      2-byte pieces (`kVec` false).
//   4. Coalesced y.  After the tile each lane writes its states' terms of
//      y_t to shared memory; the warp sums a channel's lanes, adds D * u
//      once a channel, and writes the tile's rows as 16-byte stores.
//   5. The lane map, chosen on the card (PERF.md, mamba_scan): 8 states a
//      lane (2 lanes a channel at N 16: 8 warps an SM at jamba's D), 16
//      steps a tile, 4 warps a block, 3 stages.  One lane a channel leaves
//      a scheduler one warp, 4 lanes repeat a channel's u, delta and du in
//      each, 32-step tiles make a loop of 4,000 instructions: all were
//      slower.

#include "scan_staging.cuh"

namespace {

constexpr int kLaneStates = 8;  // states a lane holds (all N where N is less)
constexpr int kTile = 16;       // steps a stage of the ring holds
constexpr int kWarps = 4;       // warps a block
constexpr int kStages = 3;      // stages of a warp's ring
static_assert(kTile % 8 == 0 && kStages >= 2 && kWarps >= 1, "ring shape");
// blocks an SM must hold for 16 warps: ptxas then gives a thread at most
// 128 registers (unbounded, some instances took 255 and spilled)
constexpr int kMinBlocks = kWarps < 16 ? 16 / kWarps : 1;

template <int N>
struct LaneMap {
  static constexpr int kStates = N < kLaneStates ? N : kLaneStates;
  static constexpr int kLanes = N / kStates;     // lanes a channel
  static constexpr int kChannels = 32 / kLanes;  // channels a warp
  static_assert(kStates % 4 == 0 && N % kStates == 0 && kLanes <= 32,
                "states a lane");
};

// a warp's stage: kTile steps of its channels' u and delta, and of B and C
template <typename T, int N>
struct alignas(16) Stage {
  T u[kTile][LaneMap<N>::kChannels];
  T dt[kTile][LaneMap<N>::kChannels];
  T b[kTile][N];
  T c[kTile][N];
};

template <typename T, int N>
struct alignas(16) WarpSmem {
  Stage<T, N> ring[kStages];
  float bc[2][kTile][N];  // bf16: the tile's B and C widened to f32
  float part[kTile][32];  // lane l's terms of y_t (its states' h . C)
  float dskip[LaneMap<N>::kChannels];
};

struct Pieces {  // bytes a staging copy or a y store moves at once
  int ud, b, c, y;
};

// kRows rows of N bf16 values as f32, one 16-byte vector (8 values) a
// piece: a tile's B or C widened once, not in every lane.
template <int kRows, int N>
__device__ __forceinline__ void widen(float* dst, const __nv_bfloat16* src,
                                      int lane) {
  constexpr int kVecs = kRows * N / 8;
  static_assert(kRows * N % 8 == 0, "whole vectors");
#pragma unroll
  for (int j = 0; j < (kVecs + 31) / 32; ++j) {
    const int v = lane + 32 * j;
    if (kVecs % 32 == 0 || v < kVecs) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + v * 8);
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 2; ++q)  // bf16 -> f32 is the top half of the bits
        *reinterpret_cast<float4*>(dst + v * 8 + 4 * q) = make_float4(
            __uint_as_float(w[2 * q] << 16),
            __uint_as_float(w[2 * q] & 0xffff0000u),
            __uint_as_float(w[2 * q + 1] << 16),
            __uint_as_float(w[2 * q + 1] & 0xffff0000u));
    }
  }
}

// The tile's y: rows [0, rows) and channels [0, cols) of the warp's
// columns, in stores of kBytes; y = (sum of the channel's lanes' terms)
// + D * u.
template <int kBytes, bool kVec, typename T, int N>
__device__ __forceinline__ void write_y(const WarpSmem<T, N>& w,
                                        const Stage<T, N>& st, T* y,
                                        long long ld, int rows, int cols,
                                        int lane) {
  using M = LaneMap<N>;
  constexpr int kV = kBytes / static_cast<int>(sizeof(T));
  constexpr int C = M::kChannels;
  constexpr int kL = M::kLanes;
  if constexpr (kV >= 1 && C % kV == 0) {
    constexpr int kRow = C / kV;  // stores a row
    constexpr int kAll = kTile * kRow;
    for_pieces<kVec, (kAll + 31) / 32>([&](int j) {
      const int p = lane + 32 * j;
      if (kAll % 32 == 0 || p < kAll) {
        const int r = p / kRow, col = p % kRow * kV;
        if (r < rows && col < cols) {
          alignas(16) float terms[kV * kL];
          alignas(16) float ds[kV];
          alignas(16) T ut[kV];
          alignas(16) T out[kV];
          load_run(terms, &w.part[r][col * kL]);
          load_run(ds, &w.dskip[col]);
          load_run(ut, &st.u[r][col]);
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            float s = terms[e * kL];
#pragma unroll
            for (int q = 1; q < kL; ++q) s = __fadd_rn(s, terms[e * kL + q]);
            put(out + e, __fadd_rn(s, __fmul_rn(ds[e], to_f32(ut[e]))));
          }
          using V = typename Word<kBytes>::type;
          *reinterpret_cast<V*>(y + r * ld + col) =
              *reinterpret_cast<const V*>(out);
        }
      }
    });
  } else {
    __trap();
  }
}

template <bool kVec, typename T, int N>
__device__ __forceinline__ void write_y_tile(int bytes,
                                             const WarpSmem<T, N>& w,
                                             const Stage<T, N>& st, T* y,
                                             long long ld, int rows,
                                             int cols, int lane) {
  if constexpr (kVec) {
    write_y<16, true>(w, st, y, ld, rows, cols, lane);
  } else {
    switch (bytes) {
      case 16: write_y<16, false>(w, st, y, ld, rows, cols, lane); break;
      case 8: write_y<8, false>(w, st, y, ld, rows, cols, lane); break;
      case 4: write_y<4, false>(w, st, y, ld, rows, cols, lane); break;
      default: write_y<2, false>(w, st, y, ld, rows, cols, lane);
    }
  }
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    mamba_scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                      const float* __restrict__ a,
                      const T* __restrict__ bmat, const T* __restrict__ cmat,
                      const float* __restrict__ dskip, T* __restrict__ y,
                      float* __restrict__ hlast, int length, int dim,
                      long long b_sb, long long b_sl, long long c_sb,
                      long long c_sl, Pieces pc) {
  using M = LaneMap<N>;
  constexpr int S = M::kStates;
  constexpr int C = M::kChannels;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = (blockIdx.x * kWarps + warp) * C;
  if (d0 >= dim) return;  // no barrier spans warps
  WarpSmem<T, N>& w = reinterpret_cast<WarpSmem<T, N>*>(smem_raw)[warp];
  const int bi = blockIdx.y;
  const int cols = min(C, dim - d0);  // this warp's channels inside D
  const int ch = lane / M::kLanes;
  const int n0 = lane % M::kLanes * S;  // this lane's states
  const bool live = ch < cols;
  const long long ld = dim;
  const long long row0 = static_cast<long long>(bi) * length * ld + d0;
  const T* up = u + row0;
  const T* dp = delta + row0;
  T* yp = y + row0;
  const T* bp = bmat + bi * b_sb;
  const T* cp = cmat + bi * c_sb;

  float ar[S], h[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    ar[k] = live ? a[static_cast<long long>(d0 + ch) * N + n0 + k] : 0.f;
    h[k] = 0.f;
  }
  if (lane < C) w.dskip[lane] = lane < cols ? dskip[d0 + lane] : 0.f;

  T zero, neg_zero;
  put(&zero, 0.f);
  put(&neg_zero, -0.f);
  const int tiles = (length + kTile - 1) / kTile;
  auto issue = [&](int k) {  // tile k's copies into its stage
    Stage<T, N>& st = w.ring[k % kStages];
    const int t0 = k * kTile;
    constexpr int kFixed = kVec ? 16 : 0;
    stage_tile<kFixed, kTile, C>(pc.ud, &st.u[0][0], up, ld, t0, length,
                                 cols, neg_zero, lane);
    stage_tile<kFixed, kTile, C>(pc.ud, &st.dt[0][0], dp, ld, t0, length,
                                 cols, zero, lane);
    stage_tile<kFixed, kTile, N>(pc.b, &st.b[0][0], bp, b_sl, t0, length, N,
                                 zero, lane);
    stage_tile<kFixed, kTile, N>(pc.c, &st.c[0][0], cp, c_sl, t0, length, N,
                                 zero, lane);
  };

#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) issue(k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    if (k + kStages - 1 < tiles) issue(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile k has landed (this lane's part)
    __syncwarp();                  // ... and every lane's
    const Stage<T, N>& st = w.ring[k % kStages];
    const float* bt;
    const float* ct;
    if constexpr (sizeof(T) == 2) {
      widen<kTile, N>(&w.bc[0][0][0], &st.b[0][0], lane);
      widen<kTile, N>(&w.bc[1][0][0], &st.c[0][0], lane);
      __syncwarp();
      bt = &w.bc[0][0][0];
      ct = &w.bc[1][0][0];
    } else {
      bt = &st.b[0][0];
      ct = &st.c[0][0];
    }
    // the tile's terms stay in registers until its last step: a store to
    // shared memory inside the tile would keep each step's loads, and so
    // its exponentials, behind the step before
    float acc[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float ut = to_f32(st.u[i][ch]);
      const float dt = to_f32(st.dt[i][ch]);
      const float du = __fmul_rn(dt, ut);
      acc[i] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < S; k4 += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bt + i * N + n0
                                                           + k4);
        const float4 c4 = *reinterpret_cast<const float4*>(ct + i * N + n0
                                                           + k4);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = k4 + e;
          const float abar = expf(__fmul_rn(dt, ar[s]));
          h[s] = __fadd_rn(__fmul_rn(abar, h[s]), __fmul_rn(du, bb[e]));
          acc[i] = fmaf(h[s], cc[e], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) w.part[i][lane] = acc[i];
    __syncwarp();
    const int t0 = k * kTile;
    write_y_tile<kVec>(pc.y, w, st, yp + t0 * ld, ld, min(kTile, length - t0),
                       cols, lane);
    __syncwarp();  // the stage and the terms are free again
  }
  if (live) {
    float* hp = hlast + (static_cast<long long>(bi) * ld + d0 + ch) * N + n0;
#pragma unroll
    for (int k4 = 0; k4 < S; k4 += 4)
      *reinterpret_cast<float4*>(hp + k4) =
          make_float4(h[k4], h[k4 + 1], h[k4 + 2], h[k4 + 3]);
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* a, const void* b,
           const void* c, const float* dskip, void* y, float* hlast,
           int batch, int length, int dim, long long b_sb, long long b_sl,
           long long c_sb, long long c_sl, cudaStream_t stream) {
  constexpr int C = LaneMap<N>::kChannels;
  constexpr long long es = sizeof(T);
  auto addr = [](const void* p) {
    return static_cast<long long>(reinterpret_cast<uintptr_t>(p));
  };
  const long long ud[] = {addr(u), addr(delta), dim * es, C * es};
  const long long bv[] = {addr(b), b_sb * es, b_sl * es, N * es};
  const long long cv[] = {addr(c), c_sb * es, c_sl * es, N * es};
  const long long yv[] = {addr(y), dim * es, C * es};
  const Pieces pc = {widest(es, ud, 4), widest(es, bv, 4), widest(es, cv, 4),
                     widest(es, yv, 3)};
  const bool vec = pc.ud == 16 && pc.b == 16 && pc.c == 16 && pc.y == 16;
  const int smem = kWarps * static_cast<int>(sizeof(WarpSmem<T, N>));
  auto kernel = vec ? mamba_scan_kernel<T, N, true>
                    : mamba_scan_kernel<T, N, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int warps = (dim + C - 1) / C;
  const dim3 grid((warps + kWarps - 1) / kWarps, batch);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(b), static_cast<const T*>(c), dskip,
      static_cast<T*>(y), hlast, length, dim, b_sb, b_sl, c_sb, c_sl, pc);
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
