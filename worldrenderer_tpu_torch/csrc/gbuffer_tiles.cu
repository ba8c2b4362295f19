// K1: the fused G-buffer tile pass on Hopper.
//
// Replaces worldrenderer_tpu/ops/gbuffer_pallas.py:860 gbuffer_tiles_dma
// (kernel body _kernel_dma, :376). It computes what that kernel computes,
// not how: for each (view, tile) it streams the tile's run of c-entry chunks
// of rebased plane records and finds, per pixel centre, the covered entry of
// least z, the first (lowest-id) one on ties; then it evaluates that entry's
// z and value planes once.
//
// Record layout (the port's own, built by ops/gbuffer.py
// _flat_chunks_finish): recs (B, 12 + 3*n_vals, L) f32, rows
// [e0 a,b,g | e1 a,b,g | e2 a,b,g | z a,b,g | value v a,b,g ...] with every
// constant rebased to the owning tile's origin; ids (B, L) i32. Tile t owns
// chunks [start_chunks[t], start_chunks[t] + n_chunks[t]), each c entries,
// ascending by triangle id; dead entries carry e0 g = -3e38.
//
// Row banding (RasterizerConfig.bin_subtile = sub > 1): the prep bins each
// tile's sub bands of tile_h / sub rows apart, and the launcher takes the
// bands as its tiles (tile_h the band's rows, n_ty the band rows). Records
// stay rebased to the output tile's origin, so a pixel of band h takes its
// tile-local ly, h * band_h rows further down, as the TPU kernel does
// (gbuffer_pallas.py:609-660): every pixel evaluates the expressions of
// sub = 1 over its band's candidates, and bands share no pixels, so no
// merge is needed and each band splits over blocks as a tile does.
//
// What bounds it: fp32 arithmetic. Evaluated pixel by pixel, an (entry,
// pixel) pair costs four planes (8 multiplies, 8 adds) and six compares,
// while an entry's 12 geometry coefficients (48 bytes) serve every pixel of
// the tile.
// The pair loop is kept free of memory traffic: a chunk's geometry is
// staged in shared memory entry-major, so a thread reads an entry as three
// float4 broadcasts; each thread keeps its pixels' best z and winner entry
// in registers, and only the winner's value planes are read at the end. A
// thread's pixels share a row (tile_scan::part_pixel), so each plane's
// b * ly is one multiply per entry, not per pixel, and the best z starts
// just above 1 (kZCap), so z < zbest also tests z <= 1: a pair costs 12
// arithmetic instructions and five compares.
//
// The work is spread over the SMs by pixels, not by tiles. Chunks per tile
// vary widely (on the headline 1 to 9, with 362 of 768 tiles empty), so
// with one block per tile a launch lasts as long as its heaviest tile. Here
// a tile of n chunks takes up to n blocks ("parts", tile_scan::split_tile):
// each scans all n chunks over its own slice of the tile's pixels, so a
// block's work is about max(n, groups) group-chunks whatever n is. Each
// pixel's scan is still one sequential pass over the tile's entries in list
// order, so the bits are those of one block per tile by construction: no
// cross-block merge. The grid is sized from shapes alone, groups x tiles
// blocks per view (groups = pixels / 256); a block whose part the tile does
// not need exits at once, and the heaviest tiles' parts are scheduled first.
// A part that scans more than one chunk stages chunk ci + 1 with cp.async
// while it scans chunk ci.
//
// Bits: planes evaluate as tile_scan::plane_sep, ((a*lx) + (b*ly)) + g with
// separately rounded __fmul_rn / __fadd_rn, the order of the plain PyTorch
// version (ops/gbuffer_cuda.py gbuffer_tiles_plain), so the two agree bit
// for bit. The scan over entries in list order with a strict z < zbest
// keeps the first winner on z ties (-0 and +0 compare equal) — the TPU
// kernel's tie rule (chunk-local first hit, strict merge across chunks).
//
// One wrapper call is one launch of one CUDA kernel.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kGeoRows = 12;
constexpr int kBackgroundId = 1 << 30;

// cp.async of one 4-byte word from device to shared memory, in the group
// that the next cp_async_commit() closes.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct K1Args {
  const float* recs;
  const int* ids;
  const int* start_chunks;
  const int* n_chunks;
  float* z_out;
  int* id_out;
  float* v_out;
  int n_rows, l_cap, n_ty, n_tx, tile_h, tile_w, n_vals, c, groups, sub;
};

// One part: NG groups of pixels from pixel p0 (tile_scan::part_pixel),
// scanned over chunks [base, base + nch) of view b. geo holds two chunk
// slots of c entries x 12 words, entry-major.
template <int NG, bool kRow>
__device__ __forceinline__ void scan_part(const K1Args& a, float* geo, int b,
                                          int tile, int base, int nch,
                                          int p0) {
  const int c = a.c;
  const int p_tile = a.tile_h * a.tile_w;
  const float* rec = a.recs + static_cast<size_t>(b) * a.n_rows * a.l_cap;

  // zbest starts at kZCap, so "z < zbest" also tests z <= 1. A band's
  // rows start band * tile_h rows down its output tile (exact in f32).
  const float band_ly =
      static_cast<float>((tile / a.n_tx) % a.sub * a.tile_h);
  float lx[NG], ly[NG], zbest[NG];
  int win[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    pixel_centre(part_pixel<NG, kRow>(p0, q, a.tile_w), a.tile_w, lx[q], ly[q]);
    ly[q] = __fadd_rn(ly[q], band_ly);
    zbest[q] = kZCap;
    win[q] = -1;
  }

  // geo[slot][j * 12 + row] = recs[b, row, (base + ci) * c + j]. Global
  // reads are coalesced along j; the shared writes are spread by cp.async.
  auto stage = [&](int slot, int ci) {
    const float* src = rec + static_cast<size_t>(base + ci) * c;
    float* dst = geo + slot * kGeoRows * c;
    for (int i = threadIdx.x; i < kGeoRows * c; i += kThreads) {
      const int row = i / c, j = i - row * c;
      cp_async4(dst + j * kGeoRows + row,
                src + static_cast<size_t>(row) * a.l_cap + j);
    }
    cp_async_commit();
  };

  if (nch > 0) stage(0, 0);
  for (int ci = 0; ci < nch; ++ci) {
    if (ci + 1 < nch) {
      stage((ci + 1) & 1, ci + 1);
      cp_async_wait<1>();  // chunk ci has landed; ci + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* g4 =
        reinterpret_cast<const float4*>(geo + (ci & 1) * kGeoRows * c);
    const int e_base = (base + ci) * c;
    for (int j = 0; j < c; ++j) {
      // [e0a e0b e0g e1a] [e1b e1g e2a e2b] [e2g za zb zg]
      const float4 r0 = g4[3 * j], r1 = g4[3 * j + 1], r2 = g4[3 * j + 2];
      // The b-terms b * ly, once per entry when the pixels share ly.
      const float h0 = __fmul_rn(r0.y, ly[0]), h1 = __fmul_rn(r1.x, ly[0]);
      const float h2 = __fmul_rn(r1.w, ly[0]), hz = __fmul_rn(r2.z, ly[0]);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float z = plane_sep_by(r2.y, kRow ? hz : __fmul_rn(r2.z, ly[q]),
                                     r2.w, lx[q]);
        const float e0 = plane_sep_by(r0.x, kRow ? h0 : __fmul_rn(r0.y, ly[q]),
                                      r0.z, lx[q]);
        const float e1 = plane_sep_by(r0.w, kRow ? h1 : __fmul_rn(r1.x, ly[q]),
                                      r1.y, lx[q]);
        const float e2 = plane_sep_by(r1.z, kRow ? h2 : __fmul_rn(r1.w, ly[q]),
                                      r2.x, lx[q]);
        if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= -1.f && z < zbest[q]) {
          zbest[q] = z;
          win[q] = e_base + j;
        }
      }
    }
    __syncthreads();  // every thread is done with this slot before it refills
  }

  // Epilogue: outputs in image layout. zbest already holds the winner's z
  // plane at this pixel (the same expression on the same coefficients).
  const int pw = a.n_tx * a.tile_w;
  const size_t img = static_cast<size_t>(a.n_ty) * a.tile_h * pw;
  const int oy = (tile / a.n_tx) * a.tile_h;
  const int ox = (tile % a.n_tx) * a.tile_w;
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int p = part_pixel<NG, kRow>(p0, q, a.tile_w);
    if (p >= p_tile) continue;
    const size_t o =
        static_cast<size_t>(oy + p / a.tile_w) * pw + ox + p % a.tile_w;
    const int w = win[q];
    a.z_out[b * img + o] = w >= 0 ? zbest[q] : inf_f();
    a.id_out[b * img + o] =
        w >= 0 ? a.ids[static_cast<size_t>(b) * a.l_cap + w] : kBackgroundId;
    const float lyq = kRow ? ly[0] : ly[q];
    for (int v = 0; v < a.n_vals; ++v) {
      float val = 0.f;
      if (w >= 0) {
        const float* r =
            rec + static_cast<size_t>(kGeoRows + 3 * v) * a.l_cap + w;
        val = plane_sep(r[0], r[a.l_cap], r[2 * static_cast<size_t>(a.l_cap)],
                        lx[q], lyq);
      }
      a.v_out[(static_cast<size_t>(b) * a.n_vals + v) * img + o] = val;
    }
  }
}

// Grid (groups * n_tiles, B): block x = (groups - 1 - part) * n_tiles +
// tile, so the blocks of the highest parts, which only the tiles of most
// chunks have, start first and the light ones fill in behind them.
template <bool kRow>
__global__ void __launch_bounds__(kThreads) gbuffer_tiles_kernel(K1Args a) {
  extern __shared__ __align__(16) float geo[];  // [2][c][12]
  const int n_tiles = a.n_ty * a.n_tx;
  const int tile = blockIdx.x % n_tiles;
  const int part = a.groups - 1 - static_cast<int>(blockIdx.x) / n_tiles;
  const int b = blockIdx.y;

  // Clamp the run to the list so a malformed start/count cannot read past it.
  const int nch_total = a.l_cap / a.c;
  int base = a.start_chunks[b * n_tiles + tile];
  int nch = a.n_chunks[b * n_tiles + tile];
  base = min(max(base, 0), nch_total);
  nch = min(max(nch, 0), nch_total - base);

  const TileSplit split = split_tile(a.groups, nch);
  if (part >= split.parts) return;  // the tile needs fewer blocks
  const int p0 = part * split.ng * kThreads;
  dispatch_groups(split.ng, [&](auto ng_c) {
    scan_part<decltype(ng_c)::value, kRow>(a, geo, b, tile, base, nch, p0);
  });
}

// The instance for a tile width: thread pixels in rows when it allows.
using KernelFn = void (*)(K1Args);
KernelFn kernel_for(int tile_w) {
  return row_mapping(tile_w) ? gbuffer_tiles_kernel<true>
                             : gbuffer_tiles_kernel<false>;
}

size_t smem_bytes(int c) {
  return 2 * static_cast<size_t>(kGeoRows) * c * sizeof(float);
}

constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace

// Launch K1 on `stream` over n_ty x n_tx tiles of tile_h x tile_w pixels:
// the output tiles, or with sub > 1 their bands (n_ty band rows of tile_h
// rows, sub of them to an output tile). Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for shapes it does not take
// (a tile of more than 16 * 256 pixels, two chunk slots above 227 KB of
// shared memory, an empty grid, band rows that do not fill whole tiles).
extern "C" int gbuffer_tiles_launch(const void* recs, const void* ids,
                                    const void* start_chunks,
                                    const void* n_chunks, void* z_out,
                                    void* id_out, void* v_out, int bsz,
                                    int n_rows, int l_cap, int n_ty, int n_tx,
                                    int tile_h, int tile_w, int n_vals, int c,
                                    int sub, void* stream) {
  const int ppt = tile_h > 0 && tile_w > 0 ? pixels_per_thread(tile_h * tile_w) : 0;
  if (bsz <= 0 || n_ty <= 0 || n_tx <= 0 || c <= 0 || l_cap % c != 0 ||
      sub <= 0 || n_ty % sub != 0 ||
      n_rows != kGeoRows + 3 * n_vals || smem_bytes(c) > kMaxSmem || ppt == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(c);
  const KernelFn kernel = kernel_for(tile_w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  K1Args a{static_cast<const float*>(recs),
           static_cast<const int*>(ids),
           static_cast<const int*>(start_chunks),
           static_cast<const int*>(n_chunks),
           static_cast<float*>(z_out),
           static_cast<int*>(id_out),
           static_cast<float*>(v_out),
           n_rows, l_cap, n_ty, n_tx, tile_h, tile_w, n_vals, c,
           ppt,  // groups of kThreads pixels: the pixels per thread of one block
           sub};
  const dim3 grid(ppt * n_ty * n_tx, bsz);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K1's resources at chunk size c and tile width tile_w: registers per
// thread, shared memory per block (bytes, static + dynamic) and resident
// blocks per SM. Returns 0 or a CUDA error.
extern "C" int gbuffer_tiles_occupancy(int c, int tile_w, int* regs,
                                       int* smem, int* blocks_per_sm) {
  const KernelFn kernel = kernel_for(tile_w);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = smem_bytes(c);
  if (dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dyn);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, dyn));
}
