// K4: the classic rasterizer's z/id tile pass on Hopper.
//
// Replaces worldrenderer_tpu/ops/rasterize_pallas.py:97
// raster_zid_tiles_pallas (kernel body _kernel, :37). One thread block per
// tile scans the tile's binned list in chunks of c entries and keeps, per
// pixel centre, the covered entry of least z; the least slot (position in
// the list) wins ties. The wrapper (ops/raster_zid_cuda.py) maps the slot to
// the triangle id, as the TPU kernel's wrapper does.
//
// Layout (built by ops/rasterize.py _gather_tile_coeffs): coeffs
// (n_tiles, 3 coef, 4 block, k) f32, blocks [e0 | e1 | e2 | z], constants
// rebased to the tile origin, invalid entries with e0 g = -3e38; counts
// (n_tiles,) i32, the live prefix of each list. The kernel scans
// ceil(count / c) chunks, as the TPU kernel does; slots at or past k are the
// TPU wrapper's padding, which never covers.
//
// What bounds it: fp32 arithmetic. Every (entry, pixel) pair costs four
// plane evaluations (a multiply, an FMA and an add each) and six compares,
// while an entry's 12 coefficients (48 bytes) serve every pixel of the tile.
// So each chunk's coefficients are staged in shared memory once and read as
// broadcasts, and each thread keeps its pixels' best z and slot in
// registers.
//
// Bits: planes evaluate as tile_scan::plane_dot, fma(b, ly, a*lx) + g, the
// reference's fp32 plane dot order; the plain version (ops/raster_zid_cuda.py)
// rounds the same way. A sequential scan in list order with a strict
// z < zbest is the TPU kernel's tie rule (least slot within a chunk, strict
// merge across chunks).

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kGeoRows = 12;
constexpr int kBackgroundSlot = 1 << 30;

// PPT pixels per thread: pixel p = threadIdx.x + q * kThreads of the tile,
// row-major (x = p % tile_w).
template <int PPT>
__global__ void __launch_bounds__(kThreads)
    raster_zid_kernel(const float* __restrict__ coeffs,
                      const int* __restrict__ counts,
                      float* __restrict__ z_out, int* __restrict__ slot_out,
                      int k, int tile_h, int tile_w, int c) {
  extern __shared__ float geo[];  // [kGeoRows][c], row = block * 3 + coef
  const int tile = blockIdx.x;
  const int p_tile = tile_h * tile_w;
  const float* co = coeffs + static_cast<size_t>(tile) * 12 * k;
  const int count = min(max(counts[tile], 0), k);
  const int nch = (count + c - 1) / c;

  float lx[PPT], ly[PPT], zbest[PPT];
  int slot[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    pixel_centre(threadIdx.x + q * kThreads, tile_w, lx[q], ly[q]);
    zbest[q] = inf_f();
    slot[q] = kBackgroundSlot;
  }

  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = ci * c;
    stage_chunk(geo, kGeoRows, c, [&](int row, int j) {
      const int blk = row / 3, coef = row - blk * 3;
      const int e = e_base + j;
      return e < k ? co[static_cast<size_t>(coef * 4 + blk) * k + e]
                   : (row == 2 ? kBigNeg : 0.f);
    });
    for (int j = 0; j < c; ++j) {
      const float e0a = geo[0 * c + j], e0b = geo[1 * c + j], e0g = geo[2 * c + j];
      const float e1a = geo[3 * c + j], e1b = geo[4 * c + j], e1g = geo[5 * c + j];
      const float e2a = geo[6 * c + j], e2b = geo[7 * c + j], e2g = geo[8 * c + j];
      const float za = geo[9 * c + j], zb = geo[10 * c + j], zg = geo[11 * c + j];
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float z = plane_dot(za, zb, zg, lx[q], ly[q]);
        if (covers(plane_dot(e0a, e0b, e0g, lx[q], ly[q]),
                   plane_dot(e1a, e1b, e1g, lx[q], ly[q]),
                   plane_dot(e2a, e2b, e2g, lx[q], ly[q]), z) &&
            z < zbest[q]) {
          zbest[q] = z;
          slot[q] = e_base + j;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * kThreads;
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(tile) * p_tile + p;
    z_out[o] = zbest[q];
    slot_out[o] = slot[q];
  }
}

}  // namespace

// Launch K4 on `stream`: z (n_tiles, tile_h * tile_w) f32 (+inf where
// nothing covers) and slot (same shape) i32 (2^30 where nothing covers).
// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for shapes it does not take (a tile of more than
// 16 * 256 pixels, a chunk whose coefficients exceed 48 KB of shared memory,
// an empty grid).
extern "C" int raster_zid_tiles_launch(const void* coeffs, const void* counts,
                                       void* z_out, void* slot_out,
                                       int n_tiles, int k, int tile_h,
                                       int tile_w, int c, void* stream) {
  const size_t smem = static_cast<size_t>(kGeoRows) * c * sizeof(float);
  const int ppt = tile_h > 0 && tile_w > 0 ? pixels_per_thread(tile_h * tile_w) : 0;
  if (n_tiles <= 0 || k <= 0 || c <= 0 || smem > 48 * 1024 || ppt == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* co = static_cast<const float*>(coeffs);
  auto* cn = static_cast<const int*>(counts);
  auto* zo = static_cast<float*>(z_out);
  auto* so = static_cast<int*>(slot_out);
  return static_cast<int>(dispatch_ppt(ppt, [&](auto ppt_c) {
    constexpr int kPpt = decltype(ppt_c)::value;
    raster_zid_kernel<kPpt><<<n_tiles, kThreads, smem, s>>>(
        co, cn, zo, so, k, tile_h, tile_w, c);
    return cudaGetLastError();
  }));
}
