// K1: the fused G-buffer tile pass on Hopper.
//
// Replaces worldrenderer_tpu/ops/gbuffer_pallas.py:860 gbuffer_tiles_dma
// (kernel body _kernel_dma, :376). It computes what that kernel computes,
// not how: one thread block per (view, tile) streams the tile's run of
// c-entry chunks of rebased plane records and finds, per pixel centre, the
// covered entry of least z, the first (lowest-id) one on ties; then it
// evaluates that entry's z and value planes once.
//
// Record layout (the port's own, built by ops/gbuffer.py
// _flat_chunks_finish): recs (B, 12 + 3*n_vals, L) f32, rows
// [e0 a,b,g | e1 a,b,g | e2 a,b,g | z a,b,g | value v a,b,g ...] with every
// constant rebased to the owning tile's origin; ids (B, L) i32. Tile t owns
// chunks [start_chunks[t], start_chunks[t] + n_chunks[t]), each c entries,
// ascending by triangle id; dead entries carry e0 g = -3e38.
//
// What bounds it: fp32 arithmetic. Every (entry, pixel) pair costs four
// plane evaluations (8 multiplies, 8 adds) and six compares, while an
// entry's 12 geometry coefficients (48 bytes) serve 2048 pixels. The design
// keeps the pair loop free of memory traffic: the chunk's geometry is staged
// in shared memory once and read as broadcasts, each thread keeps its
// pixels' best z and winner entry in registers, and only the winner's value
// planes are read at the end.
//
// Bits: planes evaluate as tile_scan::plane_sep, ((a*lx) + (b*ly)) + g with
// separately rounded __fmul_rn / __fadd_rn, the order of the plain PyTorch version
// (ops/gbuffer_cuda.py gbuffer_tiles_plain), so the two agree bit for bit.
// The scan over entries in list order with a strict z < zbest keeps the
// first winner on z ties — the TPU kernel's tie rule (chunk-local first
// hit, strict merge across chunks).

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kGeoRows = 12;
constexpr int kBackgroundId = 1 << 30;

// PPT pixels per thread: pixel p = threadIdx.x + k * kThreads of the tile,
// row-major (x = p % tile_w), so neighbouring threads write neighbouring
// addresses.
template <int PPT>
__global__ void __launch_bounds__(kThreads)
    gbuffer_tiles_kernel(const float* __restrict__ recs,
                         const int* __restrict__ ids,
                         const int* __restrict__ start_chunks,
                         const int* __restrict__ n_chunks,
                         float* __restrict__ z_out, int* __restrict__ id_out,
                         float* __restrict__ v_out, int n_rows, int l_cap,
                         int n_ty, int n_tx, int tile_h, int tile_w,
                         int n_vals, int c) {
  extern __shared__ float geo[];  // [kGeoRows][c]
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = n_ty * n_tx;
  const int p_tile = tile_h * tile_w;
  const float* rec = recs + static_cast<size_t>(b) * n_rows * l_cap;

  // Clamp the run to the list so a malformed start/count cannot read past it.
  const int nch_total = l_cap / c;
  int base = start_chunks[b * n_tiles + tile];
  int nch = n_chunks[b * n_tiles + tile];
  base = min(max(base, 0), nch_total);
  nch = min(max(nch, 0), nch_total - base);

  float lx[PPT], ly[PPT], zbest[PPT];
  int win[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    pixel_centre(threadIdx.x + k * kThreads, tile_w, lx[k], ly[k]);
    zbest[k] = inf_f();
    win[k] = -1;
  }

  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = (base + ci) * c;
    stage_chunk(geo, kGeoRows, c, [&](int row, int j) {
      return rec[static_cast<size_t>(row) * l_cap + e_base + j];
    });
    for (int j = 0; j < c; ++j) {
      const float e0a = geo[0 * c + j], e0b = geo[1 * c + j], e0g = geo[2 * c + j];
      const float e1a = geo[3 * c + j], e1b = geo[4 * c + j], e1g = geo[5 * c + j];
      const float e2a = geo[6 * c + j], e2b = geo[7 * c + j], e2g = geo[8 * c + j];
      const float za = geo[9 * c + j], zb = geo[10 * c + j], zg = geo[11 * c + j];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float z = plane_sep(za, zb, zg, lx[k], ly[k]);
        if (covers(plane_sep(e0a, e0b, e0g, lx[k], ly[k]),
                   plane_sep(e1a, e1b, e1g, lx[k], ly[k]),
                   plane_sep(e2a, e2b, e2g, lx[k], ly[k]), z) &&
            z < zbest[k]) {
          zbest[k] = z;
          win[k] = e_base + j;
        }
      }
    }
  }

  // Epilogue: outputs in image layout. zbest already holds the winner's z
  // plane at this pixel (the same expression on the same coefficients).
  const int pw = n_tx * tile_w;
  const size_t img = static_cast<size_t>(n_ty) * tile_h * pw;
  const int oy = (tile / n_tx) * tile_h;
  const int ox = (tile % n_tx) * tile_w;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(oy + p / tile_w) * pw + ox + p % tile_w;
    const int w = win[k];
    z_out[b * img + o] = w >= 0 ? zbest[k] : inf_f();
    id_out[b * img + o] = w >= 0 ? ids[static_cast<size_t>(b) * l_cap + w]
                                 : kBackgroundId;
    for (int v = 0; v < n_vals; ++v) {
      float val = 0.f;
      if (w >= 0) {
        const float* r = rec + static_cast<size_t>(kGeoRows + 3 * v) * l_cap + w;
        val = plane_sep(r[0], r[l_cap], r[2 * static_cast<size_t>(l_cap)], lx[k],
                        ly[k]);
      }
      v_out[(static_cast<size_t>(b) * n_vals + v) * img + o] = val;
    }
  }
}

}  // namespace

// Launch K1 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for shapes it does not take (a tile of
// more than 16 * 256 pixels, a chunk whose geometry exceeds 48 KB of
// shared memory, an empty grid).
extern "C" int gbuffer_tiles_launch(const void* recs, const void* ids,
                                    const void* start_chunks,
                                    const void* n_chunks, void* z_out,
                                    void* id_out, void* v_out, int bsz,
                                    int n_rows, int l_cap, int n_ty, int n_tx,
                                    int tile_h, int tile_w, int n_vals, int c,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(kGeoRows) * c * sizeof(float);
  const int ppt = tile_h > 0 && tile_w > 0 ? pixels_per_thread(tile_h * tile_w) : 0;
  if (bsz <= 0 || n_ty <= 0 || n_tx <= 0 || c <= 0 || l_cap % c != 0 ||
      n_rows != kGeoRows + 3 * n_vals || smem > 48 * 1024 || ppt == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_ty * n_tx, bsz);
  auto s = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<const float*>(recs);
  auto* i = static_cast<const int*>(ids);
  auto* sc = static_cast<const int*>(start_chunks);
  auto* nc = static_cast<const int*>(n_chunks);
  auto* zo = static_cast<float*>(z_out);
  auto* io = static_cast<int*>(id_out);
  auto* vo = static_cast<float*>(v_out);
  return static_cast<int>(dispatch_ppt(ppt, [&](auto ppt_c) {
    constexpr int kPpt = decltype(ppt_c)::value;
    gbuffer_tiles_kernel<kPpt><<<grid, kThreads, smem, s>>>(
        r, i, sc, nc, zo, io, vo, n_rows, l_cap, n_ty, n_tx, tile_h, tile_w,
        n_vals, c);
    return cudaGetLastError();
  }));
}
