// What the tile kernels share: the block size, the plane evaluations in each
// reference kernel's rounding order, a tile's pixel centres, the coverage
// test, the entry-major staging of one chunk into shared memory, the split
// of a tile's pixels over blocks and the thread-to-pixel mappings (K1-K4),
// the strict scan of K2 and K4 (dot_scan), the launch of K2-K4 over their
// tiles' parts (launch_parts) and the occupancy query. Each kernel keeps
// its own tie rule and outputs.
//
// Every plane evaluation is spelled with __fmul_rn / __fmaf_rn / __fadd_rn
// (and the build passes -fmad=false), so a kernel rounds as its plain
// PyTorch version does.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tile_scan {

constexpr int kThreads = 256;
constexpr int kMaxPpt = 16;  // K1's pixels per thread: tiles up to 16 * 256
constexpr float kBigNeg = -3.0e38f;
// The least float above 1: a covered z (at most 1) is below it, so a scan
// that starts its best z here needs no separate z <= 1 test (K1, K2, K4).
constexpr float kZCap = 1.0f + 0x1p-23f;

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

// plane_dot again, with the a-term ax = a * lx computed by the caller once
// for all of a thread's pixels that share lx: fma(b, ly, ax) + g, the same
// operations, so the same bits.
__device__ __forceinline__ float plane_dot_ax(float ax, float b, float g,
                                              float ly) {
  return __fadd_rn(__fmaf_rn(b, ly, ax), g);
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

// Stage one chunk entry-major: geo[j * kStride + row] = load(row, j) for
// `rows` rows of c entries, so a thread reads an entry's words as float4
// broadcasts. Between barriers, so no thread still reads the previous chunk
// and every thread sees the whole new one. Global reads run along j.
template <int kStride, class Load>
__device__ __forceinline__ void stage_entries(float* geo, int rows, int c,
                                              Load load) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int row = i / c, j = i - row * c;
    geo[j * kStride + row] = load(row, j);
  }
  __syncthreads();
}

// The split of a tile over blocks. A tile's pixels form `groups` groups of
// kThreads (the last one may be partial); a block (a "part") scans the
// tile's whole chunk run over the ng * kThreads pixels from its start, ng
// per thread (part_pixel, part_pixel_col), so every pixel's scan stays
// sequential in list order. ng is the largest power of two, at most `cap`
// (at most kMaxGroups), with ng * max(n, 1) <= groups for a run of n
// chunks: a part's work, ng * n group-chunks, stays at most max(groups, n)
// (capped at cap * n), and a tile of many chunks is spread over up to
// `groups` blocks instead of one.
constexpr int kMaxGroups = 8;

struct TileSplit {
  int ng;     // pixel groups per part
  int parts;  // blocks the tile takes
};

__host__ __device__ __forceinline__ TileSplit split_tile(int groups, int n,
                                                         int cap = kMaxGroups) {
  const int work = n > 1 ? n : 1;
  int ng = 1;
  while (ng * 2 <= cap && ng * 2 * work <= groups) ng *= 2;
  return {ng, (groups + ng - 1) / ng};
}

// Pixel q (of NG) of this thread in a part that starts at pixel p0:
// p0 + q * kThreads + t. When the tile width divides kThreads
// (column_mapping), p0, a multiple of kThreads, starts a row and a thread's
// NG pixels lie in one column, kThreads / tile_w rows apart: they share lx,
// so a plane's a-term a * lx is computed once per entry (K2, K4). A warp's
// 32 threads sit on 32 neighbouring pixels of one row (of whole rows when
// the tile is narrower), so stores stay coalesced. At other widths the
// same pixels, each with its own lx.
__device__ __forceinline__ int part_pixel_col(int p0, int q) {
  return p0 + q * kThreads + static_cast<int>(threadIdx.x);
}

inline bool column_mapping(int tile_w) {
  return tile_w > 0 && kThreads % tile_w == 0;
}

// Pixel q (of NG) of this thread in a part that starts at pixel p0. With
// kRow a thread's NG pixels lie in one row, step = min(tile_w / NG,
// kThreads) apart, so they share ly and a plane's b-term is computed once
// per entry, while a warp still covers runs of neighbouring pixels.
// kRow needs a power-of-two tile width of at least kMaxGroups (row_mapping):
// then tile_w / NG divides kThreads or is a multiple of it, and p0, a
// multiple of NG * kThreads, starts a row or lies in one. Otherwise
// part_pixel_col's pixel.
template <int NG, bool kRow>
__device__ __forceinline__ int part_pixel(int p0, int q, int tile_w) {
  if (!kRow) return part_pixel_col(p0, q);
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

// K2's and K4's scan of one part over its tile's nch chunks: NG groups of
// pixels from p0 (part_pixel_col), per pixel one scan in list order from
// (zbest kZCap, win -1) that makes only the strict improvements z < zbest,
// so win is the first entry in list order at the least covered z, and
// z < zbest also tests z <= 1. Planes round as plane_dot; with kCol
// (column_mapping) a thread's pixels share lx, so each plane's a-term
// a * lx is one multiply per entry and a pair costs an FMA and an add per
// plane, fma(b, ly, ax) + g: plane_dot's operations, so its bits.
// stage(e_base) stages the chunk from entry e_base into geo, entry-major at
// kStride words an entry, whose first 12 words are
// [e0a e0b e0g e1a] [e1b e1g e2a e2b] [e2g za zb zg]: three float4
// broadcasts. With kTies a covered z equal to zbest raises the thread's
// flag, and ties(e_base) then runs at the chunk's end while the chunk is
// still staged (K2's exact ties); K4 needs no tie pass.
template <int NG, bool kCol, int kStride, bool kTies, class Stage, class Ties>
__device__ __forceinline__ void dot_scan(const float* geo, int c, int nch,
                                         int p0, int tile_w, float (&lx)[NG],
                                         float (&ly)[NG], float (&zbest)[NG],
                                         int (&win)[NG], Stage&& stage,
                                         Ties&& ties) {
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    pixel_centre(part_pixel_col(p0, q), tile_w, lx[q], ly[q]);
    zbest[q] = kZCap;
    win[q] = -1;
  }
  const float4* g4 = reinterpret_cast<const float4*>(geo);
  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = ci * c;
    stage(e_base);
    bool tie = false;
    for (int j = 0; j < c; ++j) {
      const float4* g = g4 + kStride / 4 * j;
      const float4 r0 = g[0], r1 = g[1], r2 = g[2];
      // The a-terms a * lx, once per entry when the pixels share lx.
      const float h0 = __fmul_rn(r0.x, lx[0]), h1 = __fmul_rn(r0.w, lx[0]);
      const float h2 = __fmul_rn(r1.z, lx[0]), hz = __fmul_rn(r2.y, lx[0]);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float z = plane_dot_ax(kCol ? hz : __fmul_rn(r2.y, lx[q]), r2.z,
                                     r2.w, ly[q]);
        const float e0 = plane_dot_ax(kCol ? h0 : __fmul_rn(r0.x, lx[q]), r0.y,
                                      r0.z, ly[q]);
        const float e1 = plane_dot_ax(kCol ? h1 : __fmul_rn(r0.w, lx[q]), r1.x,
                                      r1.y, ly[q]);
        const float e2 = plane_dot_ax(kCol ? h2 : __fmul_rn(r1.z, lx[q]), r1.w,
                                      r2.x, ly[q]);
        if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= -1.f &&
            (kTies ? z <= zbest[q] : z < zbest[q])) {
          if (!kTies || z < zbest[q]) {
            zbest[q] = z;
            win[q] = e_base + j;
          } else {
            tie = true;
          }
        }
      }
    }
    if (kTies && tie) ties(e_base);
  }
}

// The shape of a K2, K3 or K4 launch: n_tiles tiles of tile_h * tile_w
// pixels, lists of k entries scanned in chunks of c; launch_parts sets the
// rest. The grid is max_parts * n_tiles blocks.
struct TileDims {
  int n_tiles, k, tile_h, tile_w, c;
  int groups;     // pixel groups of kThreads per tile
  int cap;        // the most groups a part takes (group_cap)
  int max_parts;  // the split of a full list of k entries: no tile needs more
};

// The part this block runs, block x = (max_parts - 1 - part) * n_tiles +
// tile, so the highest parts, which only the tiles of most chunks have,
// start first. Calls f(std::integral_constant<int, NG>(), tile, nch, p0)
// for the tile's ceil(count / c) chunks, or returns at once when the tile
// needs fewer parts (K2-K4).
template <class F>
__device__ __forceinline__ void run_part(const int* counts, const TileDims& d,
                                         F&& f) {
  const int tile = blockIdx.x % d.n_tiles;
  const int part = d.max_parts - 1 - static_cast<int>(blockIdx.x) / d.n_tiles;
  const int count = min(max(counts[tile], 0), d.k);
  const int nch = (count + d.c - 1) / d.c;
  const TileSplit split = split_tile(d.groups, nch, d.cap);
  if (part >= split.parts) return;  // the tile needs fewer blocks
  const int p0 = part * split.ng * kThreads;
  dispatch_groups(split.ng, [&](auto ng_c) { f(ng_c, tile, nch, p0); });
}

// The cap on a part's pixel groups: the largest of kMaxGroups, .., 2, 1 at
// which the tiles, counted at one chunk each (the least a scanned tile
// has), still make two waves of the `resident` blocks the card holds at
// once. Fewer groups a part means more blocks, each staging the chunk and
// setting up its pixels again, so the cap falls only while the grid is too
// small to keep every SM busy to its end. On an H100 (132 SMs, 3 or 4
// blocks each), 384 tiles of 16 groups make 768 blocks at 8 groups a part,
// under two waves, and 1,536 at 4; 1,024 such tiles make 2,048 blocks at 8.
inline int group_cap(int n_tiles, int groups, int resident) {
  int cap = kMaxGroups;
  while (cap > 1 && static_cast<long long>(n_tiles) *
                            split_tile(groups, 1, cap).parts <
                        2LL * resident) {
    cap /= 2;
  }
  return cap;
}

// Launch kernel(a) on `stream` over the grid of a.d, whose groups, cap and
// max_parts it sets from the shape and from the blocks of this kernel the
// current card holds at once. Returns 0 or a CUDA error.
template <class Args>
int launch_parts(void (*kernel)(Args), Args a, size_t smem, void* stream) {
  TileDims& d = a.d;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  d.groups = (d.tile_h * d.tile_w + kThreads - 1) / kThreads;
  d.cap = group_cap(d.n_tiles, d.groups, sms * per_sm);
  d.max_parts = split_tile(d.groups, (d.k + d.c - 1) / d.c, d.cap).parts;
  kernel<<<d.max_parts * d.n_tiles, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's registers per thread, shared memory per block (bytes, static
// + dyn_smem) and resident blocks of kThreads per SM. Returns 0 or a CUDA
// error.
template <class Kernel>
int kernel_occupancy(Kernel kernel, size_t dyn_smem, int* regs, int* smem,
                     int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dyn_smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, dyn_smem));
}

// Pixels per thread for a tile of p_tile pixels (0 if it has too many): K1's
// grid holds one part per group.
inline int pixels_per_thread(int p_tile) {
  const int ppt = (p_tile + kThreads - 1) / kThreads;
  return ppt >= 1 && ppt <= kMaxPpt ? ppt : 0;
}

}  // namespace tile_scan
