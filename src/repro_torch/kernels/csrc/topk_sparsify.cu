// Block-local top-k, for Hopper (sm_90a): with error feedback, and the
// plain sparsify.
//
// topk_encode_ef_fwd replaces the Pallas TPU kernel
// repro/kernels/topk_sparsify.py::topk_encode_ef (_topk_ef_kernel, lines
// 86-109).  Per row of block f32 values (a flat bucket folded into rows):
//   t      = g + r
//   k rounds: pick the largest |t| not yet taken, the LOWEST column on a
//             tie (lax.top_k's order), and take it
//   vals   t at the taken columns, in selection order   (k,) f32
//   idx    the taken columns                            (k,) int32
//   new_r  t - (taken ? t : 0), computed literally, so -0.0 and +0.0
//          come out bit for bit as in the reference
// A row with fewer than k nonzeros takes its lowest free zero columns, as
// the zero-padded tail block of every replica does.  vals keep t's sign,
// -0.0 included (the reference's jnp codec; its Pallas kernel returns a
// taken -0.0 as +0.0 through a masked sum).  Magnitudes are ordered by
// the bits of |t| (the sign bit cleared), so a NaN sorts above +inf, as
// lax.top_k orders it.
//
// topk_sparsify_fwd replaces repro/kernels/topk_sparsify.py::topk_sparsify
// (_topk_kernel, lines 32-53), one round of the leaf-wise codec
// (core/compression.py::ef_compress_tree, dgc_compress_tree): the same
// selection over |x| as f32 for an f32 or bf16 row x, vals = x at the
// taken columns and dense = taken ? x : +0.0, both x's own bits.
//
// Bound on the H100: device-memory bytes.  topk_encode_ef reads g and r
// and writes new_r (12 B an element); topk_sparsify reads x and writes
// dense (8 B an f32 element, 4 B a bf16 one); each row writes k values
// and k int32 indices.  At 3.35 TB/s one SM's share is ~12.8 B a cycle,
// so a 1024-wide encode row may cost ~960 cycles, ~3,800 warp
// instructions on the SM's four schedulers (a sparsify row ~2,500).
//
// Design.  One warp takes one row (block <= 1024, block % 32 == 0).  The
// row is read and written as 16-byte vectors: vector v of the row (V = 4
// f32 or 8 bf16 columns) belongs to lane v % 32, so slot s = j V + e of a
// lane is column V (lane + 32 j) + e, and a lane's slots run in column
// order.  A column's key is bits(|t|) + 1 (0 marks nothing).  The first
// design ran k rounds of a 64-bit shuffle max and a rescan of the
// winner's 32 columns, ~330 warp instructions a round: issue-bound, not
// byte-bound.  This one filters first:
//   1. tau = the k-th largest of the 32 lane maxima (k <= 32): <= k
//      rounds of redux.max and a ballot count.  The k lanes whose maxima
//      are >= tau hold k keys >= tau, so every key of the top k is >= tau.
//   2. The candidates, keys >= tau (ties at tau included), are compacted
//      into 32 shared slots of the warp by ballot offsets.  A gradient
//      row at block 1024, k 10 has ~12-15.
//   3. With C <= 32 candidates, one a lane, each of the k rounds is a
//      redux.max of the keys and a redux.min of the columns that hold it
//      (the lowest column on a tie): ~14 instructions.  The winner writes
//      its value and column; the column's owner lane sets its taken bit.
//   4. Otherwise (C > 32: ties such as an all-zero padded tail row, a
//      constant row or fewer than k nonzeros; or k > 32) the general path
//      runs k rounds over the whole row: redux.max of the lanes' best
//      untaken keys, redux.min of their lowest columns, and a rescan of
//      the winner's lane.  Slower, inside the kernel, and bit for bit the
//      same output.
// Eight warps a block and at least two blocks an SM keep >= 16 warps
// (~190 KB of a 1024-wide encode's rows) in flight against the memory's
// latency.  Candidate slots: 384 B of shared memory a warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;       // rows per thread block, one a warp
constexpr int kMinBlocks = 2;   // blocks an SM: >= 16 resident warps
constexpr int kSlots = 32;      // values a lane holds: block <= 32 * 32
constexpr int kFast = 32;       // candidates the fast path takes, one a lane
constexpr unsigned kFull = 0xffffffffu;

// A row as one lane holds it, in registers: slot s = j * V + e is column
// V * (lane + 32 j) + e, from the lane's 16-byte vector j.
struct F32Row {
  static constexpr int V = 4;
  using Raw = unsigned;
  float v[kSlots];
  __device__ __forceinline__ unsigned raw(int s) const {
    return __float_as_uint(v[s]);
  }
  __device__ __forceinline__ unsigned mag(int s) const {
    return raw(s) & 0x7fffffffu;
  }
  __device__ __forceinline__ void set(int j, uint4 u) {
    v[4 * j] = __uint_as_float(u.x);
    v[4 * j + 1] = __uint_as_float(u.y);
    v[4 * j + 2] = __uint_as_float(u.z);
    v[4 * j + 3] = __uint_as_float(u.w);
  }
  // vector j with its untaken columns +0.0
  __device__ __forceinline__ uint4 kept(int j, unsigned taken) const {
    const unsigned b = taken >> (4 * j);
    return make_uint4(b & 1u ? raw(4 * j) : 0u, b & 2u ? raw(4 * j + 1) : 0u,
                      b & 4u ? raw(4 * j + 2) : 0u,
                      b & 8u ? raw(4 * j + 3) : 0u);
  }
};

struct Bf16Row {
  static constexpr int V = 8;
  using Raw = unsigned short;
  unsigned w[kSlots / 2];  // two bf16 a word, the lower column low
  __device__ __forceinline__ unsigned raw(int s) const {
    return (s & 1) ? w[s >> 1] >> 16 : w[s >> 1] & 0xffffu;
  }
  __device__ __forceinline__ unsigned mag(int s) const {  // as f32 bits
    return (raw(s) & 0x7fffu) << 16;
  }
  __device__ __forceinline__ void set(int j, uint4 u) {
    w[4 * j] = u.x;
    w[4 * j + 1] = u.y;
    w[4 * j + 2] = u.z;
    w[4 * j + 3] = u.w;
  }
  __device__ __forceinline__ uint4 kept(int j, unsigned taken) const {
    const unsigned b = taken >> (8 * j);
    unsigned out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[q] = w[4 * j + q] & ((b >> (2 * q) & 1u ? 0x0000ffffu : 0u) |
                               (b >> (2 * q + 1) & 1u ? 0xffff0000u : 0u));
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
};

template <class Row>
__device__ __forceinline__ bool valid(int s, int lane, int nvec) {
  return lane + 32 * (s / Row::V) < nvec;
}
template <class Row>
__device__ __forceinline__ unsigned column(int s, int lane) {
  return Row::V * (lane + 32 * (s / Row::V)) + s % Row::V;
}
template <class Row>
__device__ __forceinline__ int owner(unsigned c) {
  return static_cast<int>((c / Row::V) & 31u);
}
template <class Row>
__device__ __forceinline__ unsigned slot_bit(unsigned c) {
  return 1u << ((c / (32u * Row::V)) * Row::V + c % Row::V);
}

struct Candidates {  // one warp's compacted candidates
  unsigned key[kFast], col[kFast], raw[kFast];
};

// The k picks of one row whose lane holds `row` (nvec vectors in the
// row).  Pick i calls store(i, column, raw bits of its value) on one
// lane.  Returns the lane's mask of taken slots.
template <class Row, class Store>
__device__ __forceinline__ unsigned select_topk(const Row& row, int lane,
                                                int nvec, int k,
                                                Candidates& cand,
                                                Store store) {
  unsigned taken = 0u;
  if (k <= kFast) {
    unsigned cur = 0u;  // the lane's largest key
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (valid<Row>(s, lane, nvec)) cur = max(cur, row.mag(s) + 1u);
    unsigned tau;
    for (int seen = 0;;) {  // ends: each round counts >= 1 more lane
      tau = __reduce_max_sync(kFull, cur);
      seen += __popc(__ballot_sync(kFull, cur == tau));
      if (seen >= k) break;
      if (cur == tau) cur = 0u;
    }
    int count = 0;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const unsigned key = row.mag(s) + 1u;
      const bool is = valid<Row>(s, lane, nvec) && key >= tau;
      const unsigned vote = __ballot_sync(kFull, is);
      if (is) {
        const int at = count + __popc(vote & below);
        if (at < kFast) {
          cand.key[at] = key;
          cand.col[at] = column<Row>(s, lane);
          cand.raw[at] = row.raw(s);
        }
      }
      count += __popc(vote);
    }
    if (count <= kFast) {  // count >= k: the k lanes' maxima are in
      __syncwarp();
      unsigned key = lane < count ? cand.key[lane] : 0u;
      const unsigned col = cand.col[lane];
      int won = -1;
      for (int i = 0; i < k; ++i) {
        const unsigned m = __reduce_max_sync(kFull, key);  // >= 1
        const unsigned c = __reduce_min_sync(kFull, key == m ? col : ~0u);
        if (key == m && col == c) {
          key = 0u;
          won = i;
        }
        if (owner<Row>(c) == lane) taken |= slot_bit<Row>(c);
      }
      if (won >= 0) store(won, col, cand.raw[lane]);
      return taken;
    }
  }

  // the general path: k rounds over the whole row
  unsigned best = 0u, bcol = ~0u;  // the lane's best untaken key, column
  auto rescan = [&] {
    best = 0u;
    bcol = ~0u;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (valid<Row>(s, lane, nvec) && !((taken >> s) & 1u)) {
        const unsigned key = row.mag(s) + 1u;
        if (key > best) {  // slots run in column order: lowest on a tie
          best = key;
          bcol = column<Row>(s, lane);
        }
      }
  };
  rescan();
  for (int i = 0; i < k; ++i) {
    const unsigned m = __reduce_max_sync(kFull, best);  // >= 1: k <= block
    const unsigned c = __reduce_min_sync(kFull, best == m ? bcol : ~0u);
    if (owner<Row>(c) == lane) {
      const unsigned bit = slot_bit<Row>(c);
      unsigned raw = 0u;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (bit == 1u << s) raw = row.raw(s);
      taken |= bit;
      store(i, c, raw);
      rescan();
    }
  }
  return taken;
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    topk_encode_ef_kernel(const float* __restrict__ g,
                          const float* __restrict__ r,
                          float* __restrict__ vals, int* __restrict__ idx,
                          float* __restrict__ new_r, long long rows, int block,
                          int k) {
  __shared__ Candidates cand[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rid = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (rid >= rows) return;  // whole warps leave together
  const int nvec = block / F32Row::V;
  const long long base = rid * nvec;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  const float4* r4 = reinterpret_cast<const float4*>(r) + base;

  F32Row t{};
#pragma unroll
  for (int j = 0; j < kSlots / F32Row::V; ++j)
    if (lane + 32 * j < nvec) {
      const float4 a = g4[lane + 32 * j], b = r4[lane + 32 * j];
      t.v[4 * j] = __fadd_rn(a.x, b.x);
      t.v[4 * j + 1] = __fadd_rn(a.y, b.y);
      t.v[4 * j + 2] = __fadd_rn(a.z, b.z);
      t.v[4 * j + 3] = __fadd_rn(a.w, b.w);
    }

  unsigned* vrow = reinterpret_cast<unsigned*>(vals) + rid * k;
  int* irow = idx + rid * k;
  const unsigned taken = select_topk(
      t, lane, nvec, k, cand[warp], [vrow, irow](int i, unsigned c,
                                                 unsigned raw) {
        vrow[i] = raw;
        irow[i] = static_cast<int>(c);
      });

  float4* o4 = reinterpret_cast<float4*>(new_r) + base;
#pragma unroll
  for (int j = 0; j < kSlots / F32Row::V; ++j)
    if (lane + 32 * j < nvec) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = t.v[4 * j + e];
        o[e] = __fsub_rn(x, ((taken >> (4 * j + e)) & 1u) ? x : 0.f);
      }
      o4[lane + 32 * j] = make_float4(o[0], o[1], o[2], o[3]);
    }
}

template <class Row>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    topk_sparsify_kernel(const uint4* __restrict__ x,
                         typename Row::Raw* __restrict__ vals,
                         int* __restrict__ idx, uint4* __restrict__ dense,
                         long long rows, int block, int k) {
  __shared__ Candidates cand[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rid = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (rid >= rows) return;  // whole warps leave together
  const int nvec = block / Row::V;
  const long long base = rid * nvec;

  Row t{};
#pragma unroll
  for (int j = 0; j < kSlots / Row::V; ++j)
    if (lane + 32 * j < nvec) t.set(j, x[base + lane + 32 * j]);

  typename Row::Raw* vrow = vals + rid * k;
  int* irow = idx + rid * k;
  const unsigned taken = select_topk(
      t, lane, nvec, k, cand[warp], [vrow, irow](int i, unsigned c,
                                                 unsigned raw) {
        vrow[i] = static_cast<typename Row::Raw>(raw);
        irow[i] = static_cast<int>(c);
      });

#pragma unroll
  for (int j = 0; j < kSlots / Row::V; ++j)
    if (lane + 32 * j < nvec) dense[base + lane + 32 * j] = t.kept(j, taken);
}

bool bad_limits(long long rows, int block, int k) {
  return rows < 1 || block < 32 || block % 32 != 0 ||
         block > 32 * kSlots || k < 1 || k > block ||
         (rows + kWarps - 1) / kWarps > 0x7fffffffLL;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  g, r and new_r are (rows, block) f32; vals (rows, k) f32 and
// idx (rows, k) int32.  The caller checks shapes, dtypes, devices,
// contiguity and 16-byte alignment; the limits are re-checked here.
extern "C" int topk_encode_ef_fwd(const void* g, const void* r, void* vals,
                                  void* idx, void* new_r, long long rows,
                                  int block, int k, void* stream) {
  if (bad_limits(rows, block, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(g) || !aligned16(r) || !aligned16(new_r))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  topk_encode_ef_kernel<<<grid, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(new_r), rows, block, k);
  return static_cast<int>(cudaGetLastError());
}

// Launches the sparsify kernel on `stream` and returns cudaGetLastError()
// (0 on success).  x and dense are (rows, block), vals (rows, k), all f32
// or all bf16 (is_bf16); idx is (rows, k) int32.  The caller checks
// shapes, dtypes, devices, contiguity and 16-byte alignment; the limits
// are re-checked here.
extern "C" int topk_sparsify_fwd(const void* x, void* vals, void* idx,
                                 void* dense, long long rows, int block, int k,
                                 int is_bf16, void* stream) {
  if (bad_limits(rows, block, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(dense))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned grid = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(x);
  uint4* out = static_cast<uint4*>(dense);
  if (is_bf16)
    topk_sparsify_kernel<Bf16Row><<<grid, kWarps * 32, 0, st>>>(
        in, static_cast<unsigned short*>(vals), static_cast<int*>(idx), out,
        rows, block, k);
  else
    topk_sparsify_kernel<F32Row><<<grid, kWarps * 32, 0, st>>>(
        in, static_cast<unsigned*>(vals), static_cast<int*>(idx), out, rows,
        block, k);
  return static_cast<int>(cudaGetLastError());
}
