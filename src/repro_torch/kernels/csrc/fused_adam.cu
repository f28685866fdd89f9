// Fused Adam update for Hopper (sm_90a), in place.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_adam.py::fused_adam
// (_adam_kernel, lines 19-31).  Over flat (n,) tensors:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - (lr * (m' / bc1)) / (sqrt(v' / bc2) + eps)
// with p f32 or bf16 (p' rounded to p's dtype), g, m, v f32, and
// consts = (lr, bc1, bc2) an f32 device vector, read once per thread, so
// the host never waits for the schedule's value.  p, m and v are
// overwritten with p', m' and v'.  Every operation is written as its
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA and
// each step rounds where the reference rounds.
//
// Bound on the H100: device-memory bytes.  Each element reads p, g, m, v
// and writes p, m, v: 28 B with f32 p (22 B with bf16), against ~15
// operations.
//
// Design.  The TPU kernel walks (4096,) tiles on a sequential grid with
// the constants in scalar prefetch.  Here a grid-stride loop of 256-thread
// blocks, a few per SM, covers the vector; neighbouring threads touch
// neighbouring elements, so every load and store is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TP>
__global__ void __launch_bounds__(256)
    fused_adam_kernel(TP* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ m, float* __restrict__ v,
                      const float* __restrict__ consts, long long n, float b1,
                      float omb1, float b2, float omb2, float eps) {
  const float lr = consts[0], bc1 = consts[1], bc2 = consts[2];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gi));
    const float vi =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, gi), gi));
    const float mh = __fdiv_rn(mi, bc1);
    const float vh = __fdiv_rn(vi, bc2);
    const float upd =
        __fdiv_rn(__fmul_rn(lr, mh), __fadd_rn(__fsqrt_rn(vh), eps));
    store(p + i, __fsub_rn(to_f32(p[i]), upd));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename TP>
int launch(void* p, const void* g, void* m, void* v, const void* consts,
           long long n, float b1, float omb1, float b2, float omb2, float eps,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (n + 255) / 256;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 132) * 8;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  fused_adam_kernel<TP><<<grid, 256, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(consts), n, b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  omb1 and omb2 are 1 - b1 and 1 - b2 as the caller rounds them
// to f32.  The caller checks shapes, dtypes, devices and contiguity.
extern "C" int fused_adam_fwd(void* p, const void* g, void* m, void* v,
                              const void* consts, long long n, float b1,
                              float omb1, float b2, float omb2, float eps,
                              int p_bf16, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    return launch<__nv_bfloat16>(p, g, m, v, consts, n, b1, omb1, b2, omb2,
                                 eps, s);
  return launch<float>(p, g, m, v, consts, n, b1, omb1, b2, omb2, eps, s);
}
