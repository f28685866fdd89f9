// 1-bit quantization with error feedback, packed wire format, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/onebit_quant.py::
// onebit_quant_packed (_onebit_packed_kernel, lines 85-97).  Per row of
// block f32 values (a flat bucket folded into rows, block % 8 == 0):
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
// Bound on the H100: device-memory bytes.  Each element reads g and r and
// writes new_r (12 B) plus 1/8 B of packed signs, and each row writes 2 B
// of scale: 12 + 1/8 + 2/block bytes per element.  The arithmetic is a
// handful of operations per element.
//
// Design.  The TPU kernel packs bits with one MXU matmul against a
// bit-weight matrix.  Here one warp takes one row; lane l owns bytes
// l, l + 32, ... of the row, i.e. 8 consecutive floats each, read as two
// float4.  At block 256 that is exactly one output byte per lane: the
// eight sign bits are shifts and ors in registers, the |t| sum is a
// per-lane sum and a 5-step xor-shuffle reduction, lane 0 writes the
// scale, and a second pass re-reads g and r (from L1: the warp just read
// them) to write new_r.  8 warps per block; the rows are independent.

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

  float sum = 0.f;
  for (int j = lane; j < nbytes; j += 32) {
    float t[8];
    load8(g + base + 8 * j, r + base + 8 * j, t);
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bits |= static_cast<unsigned>(t[i] >= 0.f) << i;
      sum = __fadd_rn(sum, fabsf(t[i]));
    }
    packed[row * nbytes + j] = static_cast<uint8_t>(bits);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));

  const __nv_bfloat16 s_bf =
      __float2bfloat16_rn(__fdiv_rn(sum, static_cast<float>(block)));
  if (lane == 0) scale[row] = s_bf;
  const float s = __bfloat162float(s_bf);

  for (int j = lane; j < nbytes; j += 32) {
    float t[8];
    load8(g + base + 8 * j, r + base + 8 * j, t);
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __fsub_rn(t[i], t[i] >= 0.f ? s : -s);
    float4* out = reinterpret_cast<float4*>(new_r + base + 8 * j);
    out[0] = make_float4(o[0], o[1], o[2], o[3]);
    out[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
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
