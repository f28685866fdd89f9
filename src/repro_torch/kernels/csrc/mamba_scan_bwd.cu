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
//   partial axis in a fixed order.  No float atomics, and every sum here is
//   taken in a fixed order: the same inputs give bitwise the same gradients
//   on every call.
// Everything is computed in f32.
//
// Bound on the H100: operations.  The gradient needs abar_t for every
// state and step at least once: L * D * N exponentials at 4.18e12 a second
// (16 a clock per SM, 132 SMs, 1.98 GHz).  At jamba's shape (B 1, L 2048,
// D 16384, N 16) that is 537 M exps, 0.128 ms, against 0.34 GB of inputs
// and outputs in bf16 (u, delta, dy read, du, ddelta written, 67 MB each;
// A, B, C, D and the f32 dA), 0.10 ms at 3.35 TB/s.  This design takes two
// exponentials a state-step (the forward sweep and the rebuild), so its
// own floor is 0.26 ms; its scratch (checkpoints 268 MB written and read,
// dB/dC partials 134 MB written and read, at jamba's shape) adds 0.8 GB of
// traffic, 0.24 ms, which overlaps the arithmetic.  It issues ~47 SASS
// instructions a state-step (chip_smoke.py's time_mamba_bwd reads them),
// 0.75 ms at 4 a clock an SM; the exact expf is 8 instructions, so the two
// exponentials and their products dt * A alone are 18.  Having the
// training forward write the checkpoints would save the sweep's
// exponential, but changes the forward kernel and holds the checkpoints as
// activations (ROADMAP).
//
// Design: the forward kernel's shape (mamba_scan.cu): a group of
// N / kStates neighbouring lanes owns one (b, d) channel, each lane
// kStates of its states and their values of A in registers, and every warp
// is a pipeline of its own.
//   1. Staging.  Each warp fills a ring of kStages tiles in shared memory
//      with cp.async (scan_staging.cuh), waited for with
//      cp.async.wait_group and __syncwarp.  A tile is kChunk steps of u,
//      delta (and dy) of the warp's channels and of B (and C); in the
//      reverse sweep also the warp's checkpoint before the tile.  Each
//      lane reads a step's delta, u and dy once (a broadcast over the
//      channel's lanes) and its states' B and C as vectors.
//   2. Forward sweep.  Each lane runs the recurrence over the tiles but the
//      last and stores its states before every tile into a scratch buffer
//      (B, L / kChunk, D, N) f32, in its own order.
//   3. Reverse sweep, a tile at a time from the last: the lane rebuilds the
//      tile's kChunk steps of abar and abar h_{t-1} in registers from the
//      staged checkpoint, then walks them backwards carrying g.  The sweep
//      and the rebuild round as the forward kernel and the plain version
//      do (the exact expf; dt * u, abar * h and du * B as separate
//      products; their sum; no FMA contraction), so the rebuilt states are
//      bitwise the forward's.
//   4. Reductions in registers and shuffles, no shared-memory store of a
//      term in the step loop.  A step's ddelta and du sum over n: first
//      over the lane's states, then over the channel's lanes (lanes 2q and
//      2q + 1 trade halves, then an xor butterfly: hence two lanes a
//      channel at least).  A step's dB and dC sum over the warp's channels
//      (`warp_sum`): dC = h_t dy_t in the rebuild, where h_t is at hand,
//      dB = g_t delta_t u_t in the walk.  The lanes of a state group halve
//      the lane's kStates terms, each xor level adding half of what a lane
//      holds, the first as FMAs onto the partner's products.  A lane keeps
//      its states in an order set by its lane bits (`state_perm`), so that
//      at each level its partner holds the lane's kept states in its other
//      half: no select.  B and C are kept in kRun orders a tile (`spread`)
//      for the lanes to read theirs as vectors.  After the tile the ddelta
//      and du sums are stored from registers, and each warp writes its
//      kChunk rows of dB/dC sums to shared memory; one block barrier a
//      tile, and the block adds its kWarps rows in order into its partial
//      row.  dA and dD stay in registers over the whole walk.
//   5. Registers.  The tile's abar and abar h_{t-1} cost 2 kChunk kStates
//      registers a lane: 128 at the map below, so a lane takes up to 255
//      and an SM runs 8 warps.  kChunk 8 doubles the checkpoints of a
//      16-step chunk: 268 MB at jamba's shape, written once and read once.
//      A block's kWarps * 32 / (N / kStates) channels give one dB/dC
//      partial row: 32 at jamba's N, 512 rows, 134 MB.
//   6. The lane map, chosen on the card (PERF.md, mamba_scan_bwd; timed by
//      scripts/mamba_scan_bwd_maps.py): 8 states a lane, 8-step tiles, 2
//      warps a block, 8 warps an SM.  4 states a lane at 16 warps an SM
//      (128 registers) issue 60 instructions a state-step; 16-step tiles
//      at 4 states spill; 4-step tiles double the checkpoints again; 4 or
//      8 warps a block (a barrier over more warps): all were slower.
//   Steps past L are staged as dt = 0, u = -0, B = C = dy = 0: abar = 1
//   and no term changes g, h, dA or dD; their rows are not written.
//   Channels past D are staged as zeros too and write nothing.

#include "scan_staging.cuh"

namespace {

// the lane map; kernels/mamba_scan.py mirrors kLaneStates, kChunk, kWarps
constexpr int kLaneStates = 8;  // states a lane holds (N / 2 where less)
constexpr int kChunk = 8;       // steps a tile, and between two checkpoints
constexpr int kWarps = 2;       // warps a block: one dB/dC partial row
constexpr int kStages = 3;      // tiles of a warp's ring
constexpr int kMinWarps = 8;    // warps an SM must hold: <= 255 registers
static_assert(kChunk % 4 == 0 && kStages >= 2 && kWarps >= 1, "ring shape");
constexpr int kMinBlocks = kMinWarps > kWarps ? kMinWarps / kWarps : 1;

template <int N>
struct LaneMap {
  // two lanes a channel at least: one sums its ddelta, the other its du
  static constexpr int kStates = N / 2 < kLaneStates ? N / 2 : kLaneStates;
  static constexpr int kLanes = N / kStates;     // lanes a channel
  static constexpr int kChannels = 32 / kLanes;  // channels a warp
  // values a lane reads of B or C at once, and the orders a tile's B and C
  // are kept in (`spread`)
  static constexpr int kRun = kStates < 4 ? kStates : 4;
  // a warp's channels cover every dB/dC sum once the terms are halved
  static_assert(N % kStates == 0 && kLanes >= 2 && kLanes <= 32 && N <= 16
                    && kStates >= 2, "states a lane");
};

// a warp's tile: kChunk steps of its channels' u, delta and dy, of B and
// C, and its states before the tile
template <typename T, int N>
struct alignas(16) Stage {
  static constexpr int C = LaneMap<N>::kChannels;
  T u[kChunk][C];
  T dt[kChunk][C];
  T gy[kChunk][C];
  T b[kChunk][N];
  T c[kChunk][N];
  float h0[C * N];
};

template <typename T, int N>
struct alignas(16) WarpSmem {
  Stage<T, N> ring[kStages];
  // the tile's B and C as f32, in kRun orders (`spread`)
  float bc[2][LaneMap<N>::kRun][kChunk][N];
};

// bytes a block's shared memory holds: its warps' rings, then two tiles of
// each warp's dB/dC rows (the block sums one while the next is written)
template <typename T, int N>
constexpr int smem_bytes() {
  return kWarps * static_cast<int>(sizeof(WarpSmem<T, N>))
         + 2 * kWarps * kChunk * 2 * N * static_cast<int>(sizeof(float));
}

struct Pieces {  // bytes a staging copy moves at once
  int ud, b, c;
};

// kN floats to p, as 16- or 8-byte stores where they fill whole ones (p
// aligned as for load_run).
template <int kN>
__device__ __forceinline__ void store_run(float* p, const float (&v)[kN]) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kN / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (kN % 2 == 0) {
#pragma unroll
    for (int q = 0; q < kN / 2; ++q)
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) p[e] = v[e];
  }
}

// The lane's order of its states: its register s holds state
// n0 + (s ^ perm).  perm takes the lane's bits at xor distances kLanes,
// 2 kLanes, ..., N / 2 as the bits kStates / 2, kStates / 4, ..., 1: at
// each level of `warp_sum` a lane and its partner differ in exactly the bit
// of that level, so the partner holds in its upper half the states the
// lane holds in its lower half.
template <int N>
__device__ __forceinline__ int state_perm(int lane) {
  using M = LaneMap<N>;
  int perm = 0;
#pragma unroll
  for (int h = M::kStates / 2, m = M::kLanes; h >= 1; h /= 2, m *= 2)
    if (lane & m) perm |= h;
  return perm;
}

// Rows of a tile's B or C (`src`, kChunk x N, T) into dst as f32 in kRun
// orders: order p holds row i's value of state n at [p][i][n ^ p].  A
// lane reads its states a vector (kRun values) at a time from order
// perm % kRun, the vectors swapped by perm's higher bits: its register s
// gets state n0 + (s ^ perm) with no select.
template <int N, typename T>
__device__ __forceinline__ void spread(
    float (&dst)[LaneMap<N>::kRun][kChunk][N], const T* src, int lane) {
  constexpr int K = LaneMap<N>::kRun;
  constexpr int kVecs = kChunk * N / K;
#pragma unroll
  for (int j = 0; j < (kVecs + 31) / 32; ++j) {
    const int v = lane + 32 * j;
    if (kVecs % 32 == 0 || v < kVecs) {
      alignas(16) T raw[K];
      load_run(raw, src + v * K);
#pragma unroll
      for (int p = 0; p < K; ++p) {
        float out[K];
#pragma unroll
        for (int e = 0; e < K; ++e) out[e] = to_f32(raw[e ^ p]);
        store_run(&dst[p][0][0] + v * K, out);
      }
    }
  }
}

// The lane's states' values of row i of a spread tile, in its order:
// `at` is the lane's order's first row (`spread`'s [perm % kRun][0]) and
// `off[q]` where its q-th vector starts in a row.
template <int N>
__device__ __forceinline__ void read_states(
    float (&out)[LaneMap<N>::kStates], const float* at,
    const int (&off)[LaneMap<N>::kStates / LaneMap<N>::kRun], int i) {
  constexpr int K = LaneMap<N>::kRun;
#pragma unroll
  for (int q = 0; q < LaneMap<N>::kStates / K; ++q) {
    alignas(16) float v[K];
    load_run(v, at + i * N + off[q]);
#pragma unroll
    for (int e = 0; e < K; ++e) out[q * K + e] = v[e];
  }
}

// Levels kM, 2 kM, ... of the state halving: every lane keeps registers
// [0, kH) and adds its partner's [kH, 2 kH), which hold the same states
// (`state_perm`).
template <int kH, int kM, int V>
__device__ __forceinline__ void halve(float (&v)[V]) {
  if constexpr (kH >= 1) {
#pragma unroll
    for (int j = 0; j < kH; ++j)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j + kH], kM);
    halve<kH / 2, kM * 2>(v);
  }
}

// The warp's sum over its channels of x[s] * m (one step's dB terms
// g_t * delta_t u_t, or dC terms h_t * dy_t) for the state in the lane's
// register 0.  The lanes of one state group (same lane % kLanes) hold the
// same states of different channels.  At xor distance kLanes a lane keeps
// its lower half as FMAs onto the products its partner sends of its upper
// half; distances 2 kLanes .. N / 2 halve the rest (`halve`), and
// distances N .. 16 add the copies left.
template <int N>
__device__ __forceinline__ float warp_sum(
    const float (&x)[LaneMap<N>::kStates], float m, int lane) {
  using M = LaneMap<N>;
  constexpr int H = M::kStates / 2;
  float v[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    v[j] = fmaf(x[j], m,
                __shfl_xor_sync(0xffffffffu, x[j + H] * m, M::kLanes));
  halve<H / 2, 2 * M::kLanes>(v);
#pragma unroll
  for (int k = N; k < 32; k *= 2)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], k);
  return v[0];
}

// The dB/dC column a lane writes: its state in register 0, dB where its
// bit N is clear and dC where it is set (`warp_sum` leaves both).
template <int N>
__device__ __forceinline__ int bc_column(int lane) {
  using M = LaneMap<N>;
  return (lane & N ? N : 0) + lane % M::kLanes * M::kStates
         + state_perm<N>(lane);
}

template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
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
                          long long c_sl, Pieces pc) {
  using M = LaneMap<N>;
  constexpr int S = M::kStates;
  constexpr int C = M::kChannels;
  constexpr int LN = M::kLanes;
  constexpr int K = M::kRun;
  constexpr int es = static_cast<int>(sizeof(T));
  // the widest pieces, fixed in the instance the host picks when they fit
  constexpr int kUd = !kVec ? 0 : C * es < 16 ? C * es : 16;
  constexpr int kBc = !kVec ? 0 : N * es < 16 ? N * es : 16;
  // a tile's dB/dC sums, and how many of them each thread of the block adds
  constexpr int kCells = kChunk * 2 * N;
  constexpr int kEach = (kCells + kWarps * 32 - 1) / (kWarps * 32);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  WarpSmem<T, N>& w = reinterpret_cast<WarpSmem<T, N>*>(smem_raw)[warp];
  auto& rows = *reinterpret_cast<float(*)[2][kWarps][kCells]>(
      smem_raw + kWarps * sizeof(WarpSmem<T, N>));
  const int bi = blockIdx.y;
  // every warp runs to the end, those past D on zeros: the block barrier
  // of each tile needs them all
  const int d0 = (blockIdx.x * kWarps + warp) * C;
  const int cols = max(0, min(C, dim - d0));  // this warp's channels in D
  const int ch = lane / LN;
  const int n0 = lane % LN * S;  // this lane's states: n0 + (s ^ perm)
  const int perm = state_perm<N>(lane);
  const bool live = ch < cols;
  const long long ld = dim;
  const long long row0 = static_cast<long long>(bi) * length * ld + d0;
  const T* up = u + row0;
  const T* dp = delta + row0;
  const T* gp = dy + row0;
  const T* bp = bmat + bi * b_sb;
  const T* cp = cmat + bi * c_sb;
  const int tiles = (length + kChunk - 1) / kChunk;
  const long long kstride = ld * N;  // one tile's checkpoints
  // the warp's checkpoints of tile 0; a lane's in its order
  float* kp = ckpt + static_cast<long long>(bi) * tiles * kstride
              + static_cast<long long>(d0) * N;
  const float* b_at = &w.bc[0][perm % K][0][0];
  const float* c_at = &w.bc[1][perm % K][0][0];
  int off[S / K];
#pragma unroll
  for (int q = 0; q < S / K; ++q) off[q] = n0 + ((q * K) ^ (perm & -K));

  float ar[S];
#pragma unroll
  for (int s = 0; s < S; ++s)
    ar[s] = live ? a[static_cast<long long>(d0 + ch) * N + n0 + (s ^ perm)]
                 : 0.f;
  const float dsk = live ? dskip[d0 + ch] : 0.f;

  T zero, neg_zero;
  put(&zero, 0.f);
  put(&neg_zero, -0.f);
  // tile k's copies into ring slot `slot`; the reverse sweep's also dy, C
  // and the checkpoint
  auto issue = [&](int k, int slot, bool back) {
    Stage<T, N>& st = w.ring[slot];
    const int t0 = k * kChunk;
    const long long at = t0 * ld;
    const int left = length - t0;
    stage_tile<kUd, kChunk, C>(pc.ud, &st.u[0][0], up + at, ld, 0, left,
                               cols, neg_zero, lane);
    stage_tile<kUd, kChunk, C>(pc.ud, &st.dt[0][0], dp + at, ld, 0, left,
                               cols, zero, lane);
    stage_tile<kBc, kChunk, N>(pc.b, &st.b[0][0], bp + t0 * b_sl, b_sl, 0,
                               left, N, zero, lane);
    if (back) {
      stage_tile<kUd, kChunk, C>(pc.ud, &st.gy[0][0], gp + at, ld, 0, left,
                                 cols, zero, lane);
      stage_tile<kBc, kChunk, N>(pc.c, &st.c[0][0], cp + t0 * c_sl, c_sl, 0,
                                 left, N, zero, lane);
      stage<16, 1, C * N, true>(st.h0, kp + k * kstride, 0, 0, 1, cols * N,
                                0.f, lane);
    }
  };

  // 2. the forward sweep: the states before each tile
  float h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (k + 1 < tiles) issue(k, k, false);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k + 1 < tiles; ++k) {
    if (k + kStages < tiles)
      issue(k + kStages - 1, (k + kStages - 1) % kStages, false);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile k has landed (this lane's part)
    __syncwarp();                  // ... and every lane's
    const Stage<T, N>& st = w.ring[k % kStages];
    spread<N>(w.bc[0], &st.b[0][0], lane);
    __syncwarp();
    if (live) store_run(kp + k * kstride + ch * N + n0, h);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dt = to_f32(st.dt[i][ch]);
      const float dtu = __fmul_rn(dt, to_f32(st.u[i][ch]));
      float bb[S];
      read_states<N>(bb, b_at, off, i);
#pragma unroll
      for (int s = 0; s < S; ++s)
        h[s] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, ar[s])), h[s]),
                         __fmul_rn(dtu, bb[s]));
    }
    __syncwarp();  // the stage and the spread B are free again
  }
  if (live) store_run(kp + (tiles - 1) * kstride + ch * N + n0, h);
  cp_async_wait<0>();
  __syncwarp();

  // 3. the reverse sweep, a tile at a time from the last
  float g[S], da[S];  // abar_{t+1} g_{t+1}, and dA's sum
#pragma unroll
  for (int s = 0; s < S; ++s) g[s] = da[s] = 0.f;
  float dd = 0.f;
  const int bc_col = bc_column<N>(lane);
  const bool bc_owner = (lane & (31 & ~(2 * N - 1))) == 0;
  // ddelta and du: the channel's first two lanes
  const bool writer = live && lane % LN < 2;
  T* const out_at = (lane & 1 ? du : ddelta) + row0 + ch;
#pragma unroll 1
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < tiles) issue(tiles - 1 - q, q, true);
    cp_async_commit();
  }
#pragma unroll 1
  for (int q = 0; q < tiles; ++q) {  // tile k = tiles - 1 - q
    const int k = tiles - 1 - q;
    if (q + kStages - 1 < tiles)
      issue(k - (kStages - 1), (q + kStages - 1) % kStages, true);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const Stage<T, N>& st = w.ring[q % kStages];
    spread<N>(w.bc[0], &st.b[0][0], lane);
    spread<N>(w.bc[1], &st.c[0][0], lane);
    __syncwarp();
    // the rebuild: abar_t and abar_t h_{t-1} of the tile's steps, and dC
    float ab[kChunk][S], decay[kChunk][S], dcs[kChunk];
    alignas(16) float hc[S];
    load_run(hc, st.h0 + ch * N + n0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dt = to_f32(st.dt[i][ch]);
      const float dtu = __fmul_rn(dt, to_f32(st.u[i][ch]));
      float bb[S];
      read_states<N>(bb, b_at, off, i);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ab[i][s] = expf(__fmul_rn(dt, ar[s]));
        decay[i][s] = __fmul_rn(ab[i][s], hc[s]);
        hc[s] = __fadd_rn(decay[i][s], __fmul_rn(dtu, bb[s]));
      }
      dcs[i] = warp_sum<N>(hc, to_f32(st.gy[i][ch]), lane);  // h_t dy_t
    }
    // the walk; each step's sums stay in registers until the tile is done
    float out[kChunk], dbs[kChunk];
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      const float dt = to_f32(st.dt[i][ch]);
      const float ut = to_f32(st.u[i][ch]);
      const float gy = to_f32(st.gy[i][ch]);
      float bb[S], cc[S], gt[S];
      read_states<N>(bb, b_at, off, i);
      read_states<N>(cc, c_at, off, i);
      // sums over the lane's states: A g abar h_{t-1}, and g B (du's, and
      // with u the rest of ddelta's)
      float sga = 0.f, sgb = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        gt[s] = fmaf(gy, cc[s], g[s]);              // g_t
        const float gd = gt[s] * decay[i][s];       // g_t abar_t h_{t-1}
        sga = fmaf(ar[s], gd, sga);
        sgb = fmaf(gt[s], bb[s], sgb);
        da[s] = fmaf(gd, dt, da[s]);
        g[s] = ab[i][s] * gt[s];
      }
      const float sdl = fmaf(ut, sgb, sga);
      dd = fmaf(gy, ut, dd);
      // over the channel's lanes: those with bit 0 clear sum ddelta, the
      // others du
      const bool odd = lane & 1;
      float sum = (odd ? sgb : sdl)
                  + __shfl_xor_sync(0xffffffffu, odd ? sdl : sgb, 1);
#pragma unroll
      for (int m = 2; m < LN; m *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, m);
      out[i] = odd ? fmaf(sum, dt, dsk * gy) : sum;
      dbs[i] = warp_sum<N>(gt, dt * ut, lane);  // g_t delta_t u_t
    }
    const int t0 = k * kChunk;
    const int rows_in = min(kChunk, length - t0);
    if (writer) {
      T* o = out_at + t0 * ld;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < rows_in) put(o, out[i]);
        o += ld;
      }
    }
    // dB and dC: the warp's rows, then the block's sum of them
    float* mine = rows[q & 1][warp];
    if (bc_owner) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        mine[i * 2 * N + bc_col] = lane & N ? dcs[i] : dbs[i];
    }
    __syncthreads();  // every warp's rows are in; every stage read is done
    float* part = bc_part + ((static_cast<long long>(bi) * gridDim.x
                              + blockIdx.x) * length + t0) * 2 * N;
    const float* all = rows[q & 1][0];
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int o = threadIdx.x + e * kWarps * 32;
      if ((kCells % (kWarps * 32) == 0 || o < kCells) && o < rows_in * 2 * N) {
        float sum = all[o];
#pragma unroll
        for (int x = 1; x < kWarps; ++x) sum += all[x * kCells + o];
        part[o] = sum;
      }
    }
  }
  if (live) {
    float* dap = da_part + (static_cast<long long>(bi) * ld + d0 + ch) * N
                 + n0;
#pragma unroll
    for (int s = 0; s < S; ++s) dap[s ^ perm] = da[s];
    if (lane % LN == 0) dd_part[static_cast<long long>(bi) * ld + d0 + ch] = dd;
  }
}

template <typename T, int N>
int launch(const void* u, const void* delta, const float* a, const void* b,
           const void* c, const float* dskip, const void* dy, void* du,
           void* ddelta, float* da_part, float* dd_part, float* bc_part,
           float* ckpt, int batch, int length, int dim, long long b_sb,
           long long b_sl, long long c_sb, long long c_sl, long long blocks,
           long long chunks, cudaStream_t stream) {
  constexpr int C = LaneMap<N>::kChannels;
  constexpr long long es = sizeof(T);
  const long long want = (dim + kWarps * C - 1) / (kWarps * C);
  if (blocks != want || blocks > 0x7fffffff
      || chunks != (length + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  auto addr = [](const void* p) {
    return static_cast<long long>(reinterpret_cast<uintptr_t>(p));
  };
  const long long ud[] = {addr(u), addr(delta), addr(dy), dim * es, C * es};
  const long long bv[] = {addr(b), b_sb * es, b_sl * es, N * es};
  const long long cv[] = {addr(c), c_sb * es, c_sl * es, N * es};
  const Pieces pc = {widest(es, ud, 5), widest(es, bv, 4), widest(es, cv, 4)};
  const int ud_max = C * es < 16 ? C * es : 16;
  const int bc_max = N * es < 16 ? N * es : 16;
  const bool vec = pc.ud == ud_max && pc.b == bc_max && pc.c == bc_max;
  const int smem = smem_bytes<T, N>();
  auto kernel = vec ? mamba_scan_bwd_kernel<T, N, true>
                    : mamba_scan_bwd_kernel<T, N, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(b), static_cast<const T*>(c), dskip,
      static_cast<const T*>(dy), static_cast<T*>(du), static_cast<T*>(ddelta),
      da_part, dd_part, bc_part, ckpt, length, dim, b_sb, b_sl, c_sb, c_sl,
      pc);
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
// N) f32), which must be the kernel's own counts (kWarps * 32 / (N /
// kStates) channels a block, one checkpoint every kChunk steps).  The
// caller checks devices, dtypes, shapes and contiguity and sizes the
// partials and the checkpoint scratch; the limits are re-checked here.
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
