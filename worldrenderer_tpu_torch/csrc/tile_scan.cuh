// What the tile kernels share: the block size, the plane evaluations in each
// reference kernel's rounding order, a tile's pixel centres, the coverage
// test, the staging of one chunk into shared memory, the dispatch over
// pixels per thread, and the split of a tile's pixels over blocks (K1 and
// K3). Each kernel keeps its own state and tie rule.
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

// The planes again, with the b-term b * ly computed by the caller once for
// all of a thread's pixels that share ly: the same operations, so the same
// bits. plane_sep: ((a*lx) + by) + g.
__device__ __forceinline__ float plane_sep_by(float a, float by, float g,
                                              float lx) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, lx), by), g);
}

// plane_vpu: fma(lx, a, lyb) + g with lyb = ly*b.
__device__ __forceinline__ float plane_vpu_by(float a, float lyb, float g,
                                              float lx) {
  return __fadd_rn(__fmaf_rn(lx, a, lyb), g);
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

// The split of a tile over blocks. A tile's pixels form `groups` groups of
// kThreads (the last one may be partial); a block (a "part") scans the
// tile's whole chunk run over the ng * kThreads pixels from its start, ng
// per thread (part_pixel), so every pixel's scan stays sequential in list
// order. ng is the
// largest power of two, at most kMaxGroups, with ng * max(n, 1) <= groups
// for a run of n chunks: a part's work, ng * n group-chunks, stays at most
// max(groups, n) (capped at kMaxGroups * n), and a tile of many chunks is
// spread over up to `groups` blocks instead of one.
constexpr int kMaxGroups = 8;

struct TileSplit {
  int ng;     // pixel groups per part
  int parts;  // blocks the tile takes
};

__host__ __device__ __forceinline__ TileSplit split_tile(int groups, int n) {
  const int work = n > 1 ? n : 1;
  int ng = 1;
  while (ng * 2 <= kMaxGroups && ng * 2 * work <= groups) ng *= 2;
  return {ng, (groups + ng - 1) / ng};
}

// Pixel q (of NG) of this thread in a part that starts at pixel p0. With
// kRow a thread's NG pixels lie in one row, step = min(tile_w / NG,
// kThreads) apart, so they share ly and a plane's b-term is computed once
// per entry, while a warp still covers runs of neighbouring pixels.
// kRow needs a power-of-two tile width of at least kMaxGroups (row_mapping):
// then tile_w / NG divides kThreads or is a multiple of it, and p0, a
// multiple of NG * kThreads, starts a row or lies in one. Otherwise pixel
// p0 + q * kThreads + t.
template <int NG, bool kRow>
__device__ __forceinline__ int part_pixel(int p0, int q, int tile_w) {
  if (!kRow) return p0 + q * kThreads + static_cast<int>(threadIdx.x);
  const int t = static_cast<int>(threadIdx.x);
  const int step = min(tile_w / NG, kThreads);
  return p0 + (t / step) * tile_w + t % step + q * step;
}

inline bool row_mapping(int tile_w) {
  return tile_w >= kMaxGroups && (tile_w & (tile_w - 1)) == 0;
}

// Calls f(std::integral_constant<int, NG>()) for a split's ng (1, 2, 4, 8),
// so the part's per-pixel state lives in registers of a static size.
template <class F>
__device__ __forceinline__ void dispatch_groups(int ng, F&& f) {
  switch (ng) {
    case 8: f(std::integral_constant<int, 8>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    default: f(std::integral_constant<int, 1>()); break;
  }
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
