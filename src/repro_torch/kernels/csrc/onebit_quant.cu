// 1-bit quantization with error feedback, for Hopper (sm_90a): the packed
// wire format and the unpacked variant.
//
// onebit_quant_packed_fwd replaces the Pallas TPU kernel
// repro/kernels/onebit_quant.py::onebit_quant_packed
// (_onebit_packed_kernel, lines 85-97).  Per row of block f32 values (a
// flat bucket folded into rows, block % 8 == 0):
//   t       = g + r
//   packed  byte j = sum_i (t[8j + i] >= 0) << i     (block / 8) uint8
//   scale   bf16(sum |t| / block), rounded to nearest even
//   new_r   t - sign(t) * f32(scale), sign(t) = t >= 0 ? +1 : -1
// -0.0 >= 0 holds, so a negative zero packs as +1, as on the TPU.  The sum
// is divided by block (not multiplied by a reciprocal), as jnp.mean does.
// Only the order of the f32 sum differs from the reference, so the scale
// may land one bf16 ulp away; new_r is then exact against this kernel's
// own scale (t - s * scale with s = +-1 is one rounding either way).
//
// onebit_quant_fwd replaces repro/kernels/onebit_quant.py::onebit_quant
// (_onebit_kernel, lines 34-42), one round of the leaf-wise codec
// (core/compression.py::ef_compress_tree): the same t and the same sum,
// but the signs go out as one int8 (+1 / -1) an element and the scale as
// the f32 sum |t| / block itself, with no bf16 rounding.  new_r is
// t - sign * scale against that f32 scale.
//
// Bound on the H100: device-memory bytes.  Each element reads g and r and
// writes new_r (12 B) plus 1/8 B of packed signs (packed) or 1 B of int8
// signs (unpacked); each row writes 2 B (bf16) or 4 B (f32) of scale.
// The arithmetic is a handful of operations per element.
//
// Design.  The TPU kernel packs bits with one MXU matmul against a
// bit-weight matrix.  Here one warp takes one row; lane l owns the 8-float
// chunks l, l + 32, ... of the row, read as two float4.  At block 256 that
// is exactly one chunk per lane: the eight sign bits are shifts and ors in
// registers (packed) or eight bytes of one 64-bit store (unpacked), the
// |t| sum is a per-lane sum and a 5-step xor-shuffle reduction shared by
// both kernels (row_abs_sum), lane 0 writes the scale, and a second pass
// re-reads g and r (from L1: the warp just read them) to write new_r.  8
// warps per block; the rows are independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows per thread block

__device__ __forceinline__ void load8(const float* __restrict__ g,
                                      const float* __restrict__ r,
                                      float t[8]) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4 ga = g4[0], gb = g4[1], ra = r4[0], rb = r4[1];
  t[0] = __fadd_rn(ga.x, ra.x);
  t[1] = __fadd_rn(ga.y, ra.y);
  t[2] = __fadd_rn(ga.z, ra.z);
  t[3] = __fadd_rn(ga.w, ra.w);
  t[4] = __fadd_rn(gb.x, rb.x);
  t[5] = __fadd_rn(gb.y, rb.y);
  t[6] = __fadd_rn(gb.z, rb.z);
  t[7] = __fadd_rn(gb.w, rb.w);
}

// Sum of |g + r| over the row at g, r (nchunks chunks of 8 floats), lane
// `lane` taking chunks lane, lane + 32, ...; emit(j, t) sees each chunk's
// eight t values first.  The xor-shuffle leaves the sum in every lane.
template <class Emit>
__device__ __forceinline__ float row_abs_sum(const float* __restrict__ g,
                                             const float* __restrict__ r,
                                             int nchunks, int lane,
                                             Emit emit) {
  float sum = 0.f;
  for (int j = lane; j < nchunks; j += 32) {
    float t[8];
    load8(g + 8 * j, r + 8 * j, t);
    emit(j, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, fabsf(t[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  return sum;
}

// new_r = t - (t >= 0 ? s : -s) over the row, re-reading g and r.
__device__ __forceinline__ void row_residual(const float* __restrict__ g,
                                             const float* __restrict__ r,
                                             float* __restrict__ new_r,
                                             int nchunks, int lane, float s) {
  for (int j = lane; j < nchunks; j += 32) {
    float t[8];
    load8(g + 8 * j, r + 8 * j, t);
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __fsub_rn(t[i], t[i] >= 0.f ? s : -s);
    float4* out = reinterpret_cast<float4*>(new_r + 8 * j);
    out[0] = make_float4(o[0], o[1], o[2], o[3]);
    out[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    onebit_quant_packed_kernel(const float* __restrict__ g,
                               const float* __restrict__ r,
                               uint8_t* __restrict__ packed,
                               __nv_bfloat16* __restrict__ scale,
                               float* __restrict__ new_r, long long rows,
                               int block) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int nbytes = block >> 3;
  const long long base = row * block;
  uint8_t* prow = packed + row * nbytes;

  const float sum = row_abs_sum(
      g + base, r + base, nbytes, lane, [prow](int j, const float* t) {
        unsigned bits = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          bits |= static_cast<unsigned>(t[i] >= 0.f) << i;
        prow[j] = static_cast<uint8_t>(bits);
      });
  const __nv_bfloat16 s_bf =
      __float2bfloat16_rn(__fdiv_rn(sum, static_cast<float>(block)));
  if (lane == 0) scale[row] = s_bf;
  row_residual(g + base, r + base, new_r + base, nbytes, lane,
               __bfloat162float(s_bf));
}

__global__ void __launch_bounds__(kWarps * 32)
    onebit_quant_kernel(const float* __restrict__ g,
                        const float* __restrict__ r, int8_t* __restrict__ sign,
                        float* __restrict__ scale, float* __restrict__ new_r,
                        long long rows, int block) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int nchunks = block >> 3;
  const long long base = row * block;
  int8_t* srow = sign + base;

  const float sum = row_abs_sum(
      g + base, r + base, nchunks, lane, [srow](int j, const float* t) {
        unsigned long long word = 0ull;  // byte i = int8 sign of t[i]
#pragma unroll
        for (int i = 0; i < 8; ++i)
          word |= static_cast<unsigned long long>(t[i] >= 0.f ? 0x01u : 0xffu)
                  << (8 * i);
        reinterpret_cast<unsigned long long*>(srow)[j] = word;
      });
  const float s = __fdiv_rn(sum, static_cast<float>(block));
  if (lane == 0) scale[row] = s;
  row_residual(g + base, r + base, new_r + base, nchunks, lane, s);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  g, r and new_r are (rows, block) f32, 16-byte aligned; packed
// is (rows, block / 8) uint8 and scale (rows,) bf16.  The caller checks
// shapes, dtypes, devices, alignment and contiguity; the limits are
// re-checked here.
extern "C" int onebit_quant_packed_fwd(const void* g, const void* r,
                                       void* packed, void* scale, void* new_r,
                                       long long rows, int block,
                                       void* stream) {
  if (rows < 1 || block < 8 || block % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  onebit_quant_packed_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<uint8_t*>(packed), static_cast<__nv_bfloat16*>(scale),
      static_cast<float*>(new_r), rows, block);
  return static_cast<int>(cudaGetLastError());
}

// Launches the unpacked kernel on `stream` and returns cudaGetLastError()
// (0 on success).  g, r and new_r are (rows, block) f32, 16-byte aligned;
// sign is (rows, block) int8 and scale (rows,) f32.  The caller checks
// shapes, dtypes, devices, alignment and contiguity; the limits are
// re-checked here.
extern "C" int onebit_quant_fwd(const void* g, const void* r, void* sign,
                                void* scale, void* new_r, long long rows,
                                int block, void* stream) {
  if (rows < 1 || block < 8 || block % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  onebit_quant_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(r),
      static_cast<int8_t*>(sign), static_cast<float*>(scale),
      static_cast<float*>(new_r), rows, block);
  return static_cast<int>(cudaGetLastError());
}
