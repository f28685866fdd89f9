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
// taken -0.0 as +0.0 through a masked sum).  A NaN sorts above every
// number here; the reference would take none for it (NaN gradients are
// out of scope on both sides).
//
// topk_sparsify_fwd replaces repro/kernels/topk_sparsify.py::topk_sparsify
// (_topk_kernel, lines 32-53), one round of the leaf-wise codec
// (core/compression.py::ef_compress_tree, dgc_compress_tree): the same k
// rounds over |x| in f32 for an f32 or bf16 row x, vals = x at the taken
// columns in x's dtype (as take_along_axis: a taken -0.0 stays -0.0), idx,
// and dense = taken ? x : +0.0 in x's dtype.
//
// Bound on the H100: device-memory bytes.  topk_encode_ef reads g and r
// and writes new_r (12 B an element); topk_sparsify reads x and writes
// dense (8 B an f32 element, 4 B a bf16 one); each row writes k values
// and k int32 indices.  The selection costs k passes of compares over the
// row, which stays in registers, so it adds instructions, not bytes.
//
// Design.  The TPU kernel runs k rounds of masked max over an (8, block)
// VMEM tile.  Here one warp takes one row (block <= 1024, block % 32 == 0)
// and lane l keeps columns l, l + 32, ... (block / 32 <= 32 of them) in
// registers as f32; the loads are coalesced warp reads.  Each column has
// a 64-bit key (bits(|t|) + 1) << 32 | ~column: non-negative floats order
// as their bit patterns, so the largest key is the largest magnitude and,
// among equals, the lowest column; a taken column's key is 0.  Each lane
// keeps the best key of its own columns; a round is a 5-step xor-shuffle
// max of the lanes' keys, after which only the owner lane of the winner
// marks it taken (a 32-bit mask) and rescans its own columns.  Lane i % 32
// stores round i's value and column.  No shared memory, no barriers.  Both
// kernels share that selection (select_topk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;        // rows per thread block
constexpr int kMaxPerLane = 32;  // block <= 32 * 32

__device__ __forceinline__ unsigned long long key_of(float t, int col) {
  const unsigned mag = __float_as_uint(fabsf(t)) + 1u;
  return (static_cast<unsigned long long>(mag) << 32) |
         static_cast<unsigned>(~col);
}

// k rounds of selection over one row whose lane holds t[j] = column
// lane + 32 j (j < per).  Round i calls store(i, col, v) on lane i % 32
// with the taken column and its value.  Returns the lane's mask of taken
// j.
template <class Store>
__device__ __forceinline__ unsigned select_topk(const float (&t)[kMaxPerLane],
                                                int per, int lane, int k,
                                                Store store) {
  unsigned taken = 0u;
  unsigned long long best = 0ull;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    if (j < per) {
      const unsigned long long key = key_of(t[j], lane + 32 * j);
      best = key > best ? key : best;
    }

  for (int i = 0; i < k; ++i) {
    unsigned long long m = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    const int col = static_cast<int>(~static_cast<unsigned>(m));
    const int owner = col & 31;
    const int jsel = col >> 5;
    float v = 0.f;
    if (lane == owner) {
      best = 0ull;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j)
        if (j < per) {
          if (j == jsel) {
            v = t[j];
            taken |= 1u << j;
          }
          if (!((taken >> j) & 1u)) {
            const unsigned long long key = key_of(t[j], lane + 32 * j);
            best = key > best ? key : best;
          }
        }
    }
    v = __shfl_sync(0xffffffffu, v, owner);
    if (lane == (i & 31)) store(i, col, v);
  }
  return taken;
}

__global__ void __launch_bounds__(kWarps * 32)
    topk_encode_ef_kernel(const float* __restrict__ g,
                          const float* __restrict__ r,
                          float* __restrict__ vals, int* __restrict__ idx,
                          float* __restrict__ new_r, long long rows, int block,
                          int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int per = block >> 5;
  const long long base = row * block;

  float t[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    if (j < per) {
      const long long e = base + lane + 32 * j;
      t[j] = __fadd_rn(g[e], r[e]);
    }

  float* vrow = vals + row * k;
  int* irow = idx + row * k;
  const unsigned taken =
      select_topk(t, per, lane, k, [vrow, irow](int i, int col, float v) {
        vrow[i] = v;
        irow[i] = col;
      });

#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    if (j < per)
      new_r[base + lane + 32 * j] =
          __fsub_rn(t[j], ((taken >> j) & 1u) ? t[j] : 0.f);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // exact: x came from a bf16
}

template <class T>
__global__ void __launch_bounds__(kWarps * 32)
    topk_sparsify_kernel(const T* __restrict__ x, T* __restrict__ vals,
                         int* __restrict__ idx, T* __restrict__ dense,
                         long long rows, int block, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int per = block >> 5;
  const long long base = row * block;

  float t[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    if (j < per) t[j] = to_f32(x[base + lane + 32 * j]);

  T* vrow = vals + row * k;
  int* irow = idx + row * k;
  const unsigned taken =
      select_topk(t, per, lane, k, [vrow, irow](int i, int col, float v) {
        vrow[i] = from_f32<T>(v);
        irow[i] = col;
      });

#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    if (j < per)
      dense[base + lane + 32 * j] =
          from_f32<T>(((taken >> j) & 1u) ? t[j] : 0.f);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  g, r and new_r are (rows, block) f32; vals (rows, k) f32 and
// idx (rows, k) int32.  The caller checks shapes, dtypes, devices and
// contiguity; the limits are re-checked here.
extern "C" int topk_encode_ef_fwd(const void* g, const void* r, void* vals,
                                  void* idx, void* new_r, long long rows,
                                  int block, int k, void* stream) {
  if (rows < 1 || block < 32 || block % 32 != 0 ||
      block > 32 * kMaxPerLane || k < 1 || k > block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  topk_encode_ef_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(new_r), rows, block, k);
  return static_cast<int>(cudaGetLastError());
}

// Launches the sparsify kernel on `stream` and returns cudaGetLastError()
// (0 on success).  x and dense are (rows, block), vals (rows, k), all f32
// or all bf16 (is_bf16); idx is (rows, k) int32.  The caller checks
// shapes, dtypes, devices and contiguity; the limits are re-checked here.
extern "C" int topk_sparsify_fwd(const void* x, void* vals, void* idx,
                                 void* dense, long long rows, int block, int k,
                                 int is_bf16, void* stream) {
  if (rows < 1 || block < 32 || block % 32 != 0 ||
      block > 32 * kMaxPerLane || k < 1 || k > block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    topk_sparsify_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(grid), kWarps * 32, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<__nv_bfloat16*>(vals), static_cast<int*>(idx),
            static_cast<__nv_bfloat16*>(dense), rows, block, k);
  else
    topk_sparsify_kernel<float><<<static_cast<unsigned>(grid), kWarps * 32, 0,
                                  st>>>(
        static_cast<const float*>(x), static_cast<float*>(vals),
        static_cast<int*>(idx), static_cast<float*>(dense), rows, block, k);
  return static_cast<int>(cudaGetLastError());
}
