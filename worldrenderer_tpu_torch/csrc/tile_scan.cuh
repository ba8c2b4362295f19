// What the tile kernels share: the block size, the plane evaluations in each
// reference kernel's rounding order, a tile's pixel centres, the coverage
// test, the staging of one chunk into shared memory, and the dispatch over
// pixels per thread. Each kernel keeps its own state and tie rule.
//
// Every plane evaluation is spelled with __fmul_rn / __fmaf_rn / __fadd_rn
// (and the build passes -fmad=false), so a kernel rounds as its plain
// PyTorch version does.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tile_scan {

constexpr int kThreads = 256;
constexpr int kMaxPpt = 16;  // pixels per thread: tiles up to 16 * 256 pixels
constexpr float kBigNeg = -3.0e38f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// ((a*lx) + (b*ly)) + g, separately rounded: K1.
__device__ __forceinline__ float plane_sep(float a, float b, float g, float lx,
                                           float ly) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, lx), __fmul_rn(b, ly)), g);
}

// fma(b, ly, a*lx) + g, the order in which the reference's fp32 plane dot
// (Precision.HIGHEST, XLA on the CPU) rounds: K2 and K4.
__device__ __forceinline__ float plane_dot(float a, float b, float g, float lx,
                                           float ly) {
  return __fadd_rn(__fmaf_rn(b, ly, __fmul_rn(a, lx)), g);
}

// fma(lx, a, ly*b) + g, the order in which XLA contracts K3's jitted
// elementwise form lx*a + ly*b + g: K3.
__device__ __forceinline__ float plane_vpu(float a, float b, float g, float lx,
                                           float ly) {
  return __fadd_rn(__fmaf_rn(lx, a, __fmul_rn(ly, b)), g);
}

// Pixel p of a row-major tile: its centre (lx, ly) in tile coordinates.
__device__ __forceinline__ void pixel_centre(int p, int tile_w, float& lx,
                                             float& ly) {
  lx = static_cast<float>(p % tile_w) + 0.5f;
  ly = static_cast<float>(p / tile_w) + 0.5f;
}

// Inside all three edges and the depth range.
__device__ __forceinline__ bool covers(float e0, float e1, float e2, float z) {
  return e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= -1.f && z <= 1.f;
}

// Stage one chunk: geo[row * c + j] = load(row, j) for `rows` rows of c
// words, between barriers, so no thread still reads the previous chunk and
// every thread sees the whole new one.
template <class Load>
__device__ __forceinline__ void stage_chunk(float* geo, int rows, int c,
                                            Load load) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int row = i / c;
    geo[i] = load(row, i - row * c);
  }
  __syncthreads();
}

// Pixels per thread for a tile of p_tile pixels (0 if it has too many).
inline int pixels_per_thread(int p_tile) {
  const int ppt = (p_tile + kThreads - 1) / kThreads;
  return ppt >= 1 && ppt <= kMaxPpt ? ppt : 0;
}

// Calls launch(std::integral_constant<int, P>()) for the least P of
// 1, 2, 4, 8, 16 that is at least ppt.
template <class Launch>
cudaError_t dispatch_ppt(int ppt, Launch&& launch) {
  if (ppt <= 1) return launch(std::integral_constant<int, 1>());
  if (ppt <= 2) return launch(std::integral_constant<int, 2>());
  if (ppt <= 4) return launch(std::integral_constant<int, 4>());
  if (ppt <= 8) return launch(std::integral_constant<int, 8>());
  return launch(std::integral_constant<int, 16>());
}

}  // namespace tile_scan
