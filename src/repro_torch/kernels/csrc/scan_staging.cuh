// Staging for the selective-scan kernels (mamba_scan.cu, mamba_scan_bwd.cu):
// each warp copies tiles of rows into a ring of its own in shared memory
// with cp.async, waited for with cp.async.wait_group and __syncwarp.
//
// A tile is kRows rows of W elements; row t of a matrix starts at
// src + t * ld.  Pieces are 16, 8, 4 or 2 bytes: the host picks the widest
// that divides every pointer, stride and row width (`widest`), so that a
// B/C slice at an odd column or a ragged D is staged in narrower pieces by
// the same kernel.  Rows at or past `length` and columns at or past `cols`
// take a pad value instead of a copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int kBytes>
struct Word;
template <>
struct Word<16> { using type = uint4; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<4> { using type = unsigned; };
template <>
struct Word<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void copy_piece(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
  } else {  // bf16 at an odd element offset: a plain copy
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// `body(j)` for j in [0, n): unrolled in the widest-piece instance (one or
// two pieces a lane), a loop in the others, whose unrolled pieces for every
// width ran the address arithmetic out of registers.
template <bool kUnroll, int n, typename F>
__device__ __forceinline__ void for_pieces(F&& body) {
  if constexpr (kUnroll) {
#pragma unroll
    for (int j = 0; j < n; ++j) body(j);
  } else {
#pragma unroll 1
    for (int j = 0; j < n; ++j) body(j);
  }
}

// Rows [t0, t0 + kRows) of a matrix whose row t starts at src + t * ld
// (elements) into dst[kRows][W], in pieces of kBytes; rows at or past
// `length` and columns at or past `cols` take `pad` instead.
template <int kBytes, int kRows, int W, bool kUnroll, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld,
                                      int t0, int length, int cols, T pad,
                                      int lane) {
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));
  if constexpr (kPer >= 1 && W % kPer == 0) {
    constexpr int kRow = W / kPer;  // pieces a row
    constexpr int kAll = kRows * kRow;
    for_pieces<kUnroll, (kAll + 31) / 32>([&](int j) {
      const int p = lane + 32 * j;
      if (kAll % 32 == 0 || p < kAll) {
        const int r = p / kRow, col = p % kRow * kPer;
        T* d = dst + r * W + col;
        if (t0 + r < length && col < cols) {
          copy_piece<kBytes>(d, src + static_cast<long long>(t0 + r) * ld
                                    + col);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) d[e] = pad;
        }
      }
    });
  } else {
    __trap();  // the host never picks a piece wider than the row
  }
}

// `stage` in the pieces the host picked: kFixed bytes in the instance
// built for the widest pieces (kFixed > 0), else `bytes` at run time.
template <int kFixed, int kRows, int W, typename T>
__device__ __forceinline__ void stage_tile(int bytes, T* dst, const T* src,
                                           long long ld, int t0, int length,
                                           int cols, T pad, int lane) {
  if constexpr (kFixed > 0) {
    stage<kFixed, kRows, W, true>(dst, src, ld, t0, length, cols, pad, lane);
  } else {
    switch (bytes) {
      case 16:
        stage<16, kRows, W, false>(dst, src, ld, t0, length, cols, pad, lane);
        break;
      case 8:
        stage<8, kRows, W, false>(dst, src, ld, t0, length, cols, pad, lane);
        break;
      case 4:
        stage<4, kRows, W, false>(dst, src, ld, t0, length, cols, pad, lane);
        break;
      default:
        stage<2, kRows, W, false>(dst, src, ld, t0, length, cols, pad, lane);
    }
  }
}

// kN values at p; as 16- or 8-byte accesses where they fill whole ones (p
// is then aligned to them: every caller's offset is a multiple of the
// run's length).
template <int kN, typename T>
__device__ __forceinline__ void load_run(T (&out)[kN], const T* p) {
  constexpr int kBytes = kN * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q)
      reinterpret_cast<uint4*>(out)[q] = reinterpret_cast<const uint4*>(p)[q];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 8; ++q)
      reinterpret_cast<uint2*>(out)[q] = reinterpret_cast<const uint2*>(p)[q];
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = p[e];
  }
}

// The widest of 16, 8, 4 (and 2 for bf16) bytes that divides every value.
inline int widest(int esize, const long long* v, int n) {
  for (int w = 16; w > esize; w >>= 1) {
    bool ok = true;
    for (int i = 0; i < n; ++i) ok = ok && (v[i] < 0 ? -v[i] : v[i]) % w == 0;
    if (ok) return w;
  }
  return esize;
}

}  // namespace
