// K4: the classic rasterizer's z/id tile pass on Hopper.
//
// Replaces worldrenderer_tpu/ops/rasterize_pallas.py:97
// raster_zid_tiles_pallas (kernel body _kernel, :37). It scans each tile's
// binned list in chunks of c entries and keeps, per pixel centre, the
// covered entry of least z; the least slot (position in the list) wins
// ties. It writes the winning slot's triangle id + 1 (0 where nothing
// covers), the map the TPU kernel's wrapper makes from its slots.
//
// Layout (built by ops/rasterize.py _gather_tile_coeffs): coeffs
// (n_tiles, 3 coef, 4 block, k) f32, blocks [e0 | e1 | e2 | z], constants
// rebased to the tile origin, invalid entries with e0 g = -3e38; ids
// (n_tiles, k) i32, the triangle of each slot; counts (n_tiles,) i32, the
// live prefix of each list. The kernel scans ceil(count / c) chunks, as
// the TPU kernel does; slots at or past k are the TPU wrapper's padding,
// which never covers.
//
// What bounds it: fp32 arithmetic. Every (entry, pixel) pair costs four
// plane evaluations and five compares, while an entry's 12 coefficients
// (48 bytes) serve every pixel of the tile. So each chunk's coefficients
// are staged in shared memory once per block, entry-major, so a thread
// reads an entry as three float4 broadcasts, and each thread keeps its
// pixels' best z and slot in registers. The scan is K2's
// (tile_scan::dot_scan, without K2's tie pass): a tile's pixels are split
// over blocks (tile_scan::run_part), so a tile of any size runs; a
// thread's pixels share a column when the tile width divides kThreads, so
// each plane's a*lx is one multiply per entry and a pair costs an FMA and
// an add per plane.
//
// Bits: planes evaluate as tile_scan::plane_dot, fma(b, ly, a*lx) + g, the
// reference's fp32 plane dot order; the plain version
// (ops/raster_zid_cuda.py) rounds the same way. A sequential scan in list
// order with a strict z < zbest is the TPU kernel's tie rule (least slot
// within a chunk, strict merge across chunks), so K4 needs no tie pass.
// z of a covered pixel is never -0: the TPU kernel's plane dot accumulates
// from +0, so the store adds +0, as the plain version does.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kGeoRows = 12;  // words per staged entry, three float4

struct ZidArgs {
  const float* coeffs;
  const int* ids;
  const int* counts;
  float* z_out;
  int* id_out;
  TileDims d;
};

// One part of a tile: NG groups of pixels from p0 (tile_scan::part_pixel_col)
// over the tile's nch chunks.
template <int NG, bool kCol>
__device__ __forceinline__ void zid_part(const ZidArgs& a, float* geo,
                                         int tile, int nch, int p0) {
  const int k = a.d.k;
  const int p_tile = a.d.tile_h * a.d.tile_w;
  const float* co = a.coeffs + static_cast<size_t>(tile) * kGeoRows * k;

  float lx[NG], ly[NG], zbest[NG];
  int win[NG];
  // geo[j * 12 + row], row = block * 3 + coef.
  const auto stage = [&](int e_base) {
    stage_entries<kGeoRows>(geo, kGeoRows, a.d.c, [&](int row, int j) {
      const int blk = row / 3, coef = row - blk * 3;
      const int e = e_base + j;
      return e < k ? co[static_cast<size_t>(coef * 4 + blk) * k + e]
                   : (row == 2 ? kBigNeg : 0.f);
    });
  };
  dot_scan<NG, kCol, kGeoRows, false>(geo, a.d.c, nch, p0, a.d.tile_w, lx, ly,
                                      zbest, win, stage, [](int) {});

#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int p = part_pixel_col(p0, q);
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(tile) * p_tile + p;
    const int w = win[q];
    a.z_out[o] = w >= 0 ? __fadd_rn(zbest[q], 0.f) : inf_f();
    a.id_out[o] = w >= 0 ? a.ids[static_cast<size_t>(tile) * k + w] + 1 : 0;
  }
}

// Grid (max_parts * n_tiles), as tile_scan::run_part lays it out.
template <bool kCol>
__global__ void __launch_bounds__(kThreads) raster_zid_kernel(ZidArgs a) {
  extern __shared__ __align__(16) float geo[];  // [c][12]
  run_part(a.counts, a.d, [&](auto ng_c, int tile, int nch, int p0) {
    zid_part<decltype(ng_c)::value, kCol>(a, geo, tile, nch, p0);
  });
}

// The instance for a tile width: a thread's pixels in one column when it
// allows.
using KernelFn = void (*)(ZidArgs);
KernelFn kernel_for(int tile_w) {
  return column_mapping(tile_w) ? raster_zid_kernel<true>
                                : raster_zid_kernel<false>;
}

size_t smem_bytes(int c) {
  return static_cast<size_t>(kGeoRows) * c * sizeof(float);
}

}  // namespace

// Launch K4 on `stream`: z (n_tiles, tile_h * tile_w) f32 (+inf where
// nothing covers) and the winner's triangle id + 1 (same shape) i32 (0
// where nothing covers). A tile of any size splits into groups of kThreads
// pixels. Returns 0 on success or a CUDA error; cudaErrorInvalidValue for
// shapes it does not take (an empty grid, a chunk whose coefficients
// exceed 48 KB of shared memory).
extern "C" int raster_zid_tiles_launch(const void* coeffs, const void* ids,
                                       const void* counts, void* z_out,
                                       void* id_out, int n_tiles, int k,
                                       int tile_h, int tile_w, int c,
                                       void* stream) {
  if (n_tiles <= 0 || k <= 0 || tile_h <= 0 || tile_w <= 0 || c <= 0 ||
      smem_bytes(c) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ZidArgs a{static_cast<const float*>(coeffs), static_cast<const int*>(ids),
            static_cast<const int*>(counts), static_cast<float*>(z_out),
            static_cast<int*>(id_out), {n_tiles, k, tile_h, tile_w, c}};
  return launch_parts(kernel_for(tile_w), a, smem_bytes(c), stream);
}

// K4's resources at chunk size c and tile width tile_w: registers per
// thread, shared memory per block (bytes, static + dynamic) and resident
// blocks per SM. Returns 0 or a CUDA error.
extern "C" int raster_zid_tiles_occupancy(int c, int tile_w, int* regs,
                                          int* smem, int* blocks_per_sm) {
  return kernel_occupancy(kernel_for(tile_w), smem_bytes(c), regs, smem,
                          blocks_per_sm);
}
