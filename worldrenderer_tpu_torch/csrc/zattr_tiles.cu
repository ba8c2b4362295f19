// K2 and K3: the per-tile fused z + attribute pass on Hopper, two kernels of
// one contract.
//
// K2 (zattr_kernel) replaces worldrenderer_tpu/ops/gbuffer_pallas.py:290
// zattr_tiles_pallas (kernel body _kernel, :30); K3 (zattr_vpu_kernel)
// replaces :209 zattr_tiles_vpu (kernel body _kernel_vpu, :114).
//
// Layout (built by ops/gbuffer.py _zattr_inputs): coeffs
// (n_tiles, 3 coef, r, k) f32 with r = 5 + n_vals row blocks [e0 | e1 | e2 |
// z | id | value 0 .. value n_vals-1], constants rebased to the tile origin;
// the id block is a constant plane (a = b = 0, g = triangle id), invalid
// entries carry e0 g = -3e38. counts (n_tiles,) i32 is each list's live
// prefix; both kernels scan ceil(count / c) chunks of c entries, as the TPU
// kernels do, and slots at or past k are the TPU wrappers' padding, which
// never covers. Outputs, tile-major: z (n_tiles, P) f32 (+inf on
// background), id (n_tiles, P) f32 (2^30 on background), values
// (n_tiles, n_vals, P) f32 (0 on background).
//
// The contract: per pixel centre the covered entry of least z; among the
// entries of least z, K2 takes those of the first chunk that reaches it and
// among those the least id, K3 applies its lane-slot rule (below). Its
// value planes are that entry's. A tile's entries
// carry distinct ids (the binning lists a triangle once per tile), so the
// TPU kernels' masked sum over winners is the one winner's value; a zero
// sum is +0, which the kernels reproduce by adding +0.
//
// What bounds them: fp32 arithmetic. Every (entry, pixel) pair costs four
// plane evaluations of an FMA and an add, and five compares: K2's a*lx is
// shared along a column, K3's ly*b along a row. An entry's 13 geometry and
// id words serve every pixel of the tile. Both keep the pair loop free of
// device-memory traffic: a chunk's scan words in shared memory, per-pixel
// state in registers. Both split a tile's pixels over blocks
// (tile_scan::run_part), so a tile of any size runs, and the 4,096-pixel
// tiles of workload 1 run as two or more blocks each.
//
// Bits: K2 evaluates planes as tile_scan::plane_dot, fma(b, ly, a*lx) + g,
// the order in which the reference's fp32 plane dot (Precision.HIGHEST, XLA
// on the CPU) rounds; K3 as tile_scan::plane_vpu, fma(lx, a, ly*b) + g, the
// order in which XLA contracts K3's jitted elementwise form lx*a + ly*b + g.
// The plain versions (ops/zattr_cuda.py) round the same ways.

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kScanRows = 13;  // e0, e1, e2, z (a, b, g each) and the id g
constexpr int kStride = 16;    // words per staged entry: 13 used
constexpr float kBackgroundId = 1073741824.f;  // 2^30

// Coefficient `coef` of block `blk` of entry e; the padding past k is the
// TPU wrappers' edge0_pad_block (zero but e0 g = -3e38).
__device__ __forceinline__ float coef_at(const float* co, int r, int k,
                                         int coef, int blk, int e) {
  if (e >= k) return (coef == 2 && blk == 0) ? kBigNeg : 0.f;
  return co[(static_cast<size_t>(coef) * r + blk) * k + e];
}

// Stage the chunk of entries e_base .. e_base + c - 1 entry-major:
// geo[j * 16 + row], row = block * 3 + coef for the four geometry blocks,
// row 12 the id block's g (block 4, coef 2). An entry reads as
// [e0a e0b e0g e1a] [e1b e1g e2a e2b] [e2g za zb zg] [id - - -].
__device__ __forceinline__ void stage_scan_words(float* geo, const float* co,
                                                 int r, int k, int c,
                                                 int e_base) {
  stage_entries<kStride>(geo, kScanRows, c, [&](int row, int j) {
    const int blk = row < 12 ? row / 3 : 4;
    const int coef = row < 12 ? row - blk * 3 : 2;
    return coef_at(co, r, k, coef, blk, e_base + j);
  });
}

struct ZattrArgs {
  const float* coeffs;
  const int* counts;
  float* z_out;
  float* id_out;
  float* v_out;
  int n_vals;
  TileDims d;
};

// ---- K2: one scan per pixel in list order, exact ties once per chunk. ----
//
// K2's contract (the TPU kernel's per-chunk least z and least id among its
// ties, then a strict merge across chunks): the winner is the entry of
// least id among the covered entries at the pixel's least z of the first
// chunk that reaches that z (the first in list order among equal ids). That
// is one scan per pixel in list order with one state (zbest, win): the hot
// loop makes only the strict improvements z < zbest, so win is the first
// entry of the chunk that lowered zbest to its final value, and an equal z
// only raises the thread's tie flag. The ties are settled at the end of the
// chunk, while it is still staged (dot_tie_pass): at each pixel whose best
// was set in this chunk (win >= e_base), a later covered entry of the chunk
// at zbest replaces win when its id is smaller. A best set in an earlier
// chunk stays: the merge is strict. Exact ties are rare on real inputs, and
// keeping them out of the entry loop keeps that loop's state to zbest and
// win; the id is read from the winner at the end. zbest starts at kZCap, so
// the strict z < zbest also tests z <= 1; a z of kZCap itself only raises
// the flag, and the tie pass skips a pixel that has no winner.
//
// z of a covered pixel is never -0 in K2 (nor in K4): the TPU kernel's
// plane dot accumulates from +0, where fma(b, ly, a*lx) + g gives -0 for a
// plane whose a, b and g are all -0. The store adds +0, as the plain version
// does; the scan's compares do not see the sign.
//
// The structure is K3's: chunks staged entry-major (stage_scan_words), a
// tile's pixels split over blocks. The scan is tile_scan::dot_scan, which
// K4 runs too: a thread's pixels share a column when the tile width
// divides kThreads, so each plane's a*lx is one multiply per entry and a
// pair costs an FMA and an add per plane. The winner's value planes are
// evaluated once at the end (plus +0).

// At each of a thread's pixels whose best was set in the staged chunk
// (entries e_base ..), a later covered entry of the chunk at zbest takes
// the winner's place when its id is smaller, so the least id wins.
template <int NG, bool kCol>
__device__ __forceinline__ void dot_tie_pass(const float* geo, int c,
                                             int e_base, const float* lx,
                                             const float* ly,
                                             const float* zbest, int* win) {
  const float4* g4 = reinterpret_cast<const float4*>(geo);
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    if (win[q] < e_base) continue;  // set in an earlier chunk, or none
    const float lxq = kCol ? lx[0] : lx[q];
    float idw = geo[(win[q] - e_base) * kStride + 12];
    for (int j = win[q] - e_base + 1; j < c; ++j) {
      const float id = geo[j * kStride + 12];
      if (!(id < idw)) continue;
      const float4 r0 = g4[4 * j], r1 = g4[4 * j + 1], r2 = g4[4 * j + 2];
      const float z = plane_dot(r2.y, r2.z, r2.w, lxq, ly[q]);
      if (z == zbest[q] &&
          covers(plane_dot(r0.x, r0.y, r0.z, lxq, ly[q]),
                 plane_dot(r0.w, r1.x, r1.y, lxq, ly[q]),
                 plane_dot(r1.z, r1.w, r2.x, lxq, ly[q]), z)) {
        idw = id;
        win[q] = e_base + j;
      }
    }
  }
}

// One part of a tile: NG groups of pixels from p0 (tile_scan::part_pixel_col)
// over the tile's nch chunks.
template <int NG, bool kCol>
__device__ __forceinline__ void dot_part(const ZattrArgs& a, float* geo,
                                         int tile, int nch, int p0) {
  const int c = a.d.c, k = a.d.k;
  const int r = 5 + a.n_vals;
  const int p_tile = a.d.tile_h * a.d.tile_w;
  const float* co = a.coeffs + static_cast<size_t>(tile) * 3 * r * k;

  float lx[NG], ly[NG], zbest[NG];
  int win[NG];
  dot_scan<NG, kCol, kStride, true>(
      geo, c, nch, p0, a.d.tile_w, lx, ly, zbest, win,
      [&](int e_base) { stage_scan_words(geo, co, r, k, c, e_base); },
      [&](int e_base) {
        dot_tie_pass<NG, kCol>(geo, c, e_base, lx, ly, zbest, win);
      });

#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int p = part_pixel_col(p0, q);
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(tile) * p_tile + p;
    const int w = win[q];
    const float lxq = kCol ? lx[0] : lx[q];
    a.z_out[o] = w >= 0 ? __fadd_rn(zbest[q], 0.f) : inf_f();
    a.id_out[o] = w >= 0 ? coef_at(co, r, k, 2, 4, w) : kBackgroundId;
    for (int v = 0; v < a.n_vals; ++v) {
      float val = 0.f;
      if (w >= 0) {
        val = __fadd_rn(plane_dot(coef_at(co, r, k, 0, 5 + v, w),
                                  coef_at(co, r, k, 1, 5 + v, w),
                                  coef_at(co, r, k, 2, 5 + v, w), lxq, ly[q]),
                        0.f);
      }
      a.v_out[(static_cast<size_t>(tile) * a.n_vals + v) * p_tile + p] = val;
    }
  }
}

// Grid (max_parts * n_tiles), as tile_scan::run_part lays it out.
template <bool kCol>
__global__ void __launch_bounds__(kThreads) zattr_kernel(ZattrArgs a) {
  extern __shared__ __align__(16) float geo[];  // [c][16]
  run_part(a.counts, a.d, [&](auto ng_c, int tile, int nch, int p0) {
    dot_part<decltype(ng_c)::value, kCol>(a, geo, tile, nch, p0);
  });
}

// ---- K3: one sequential scan per pixel that keeps K3's slot rule. --------
//
// K3's contract (the TPU kernel's per-lane-slot running buffers, then a
// cross-slot reduction): lane slot s (entries s, s + c, s + 2c, ...) keeps
// the first entry in chunk order that reaches its least covered z; across
// slots the winner has the least z, then the least id, then the least slot.
// That is one scan per pixel in (chunk, slot) order — list order — with one
// state (zbest, win), win's id and slot (win % c) read when needed, under
// this rule: a covered entry (chunk ci, slot s) replaces the state when
// z < zbest, or when z == zbest, (id, s) < (id of win, slot of win), and
// slot s did not reach zbest in an earlier chunk (then that earlier entry is
// the slot's, under K3's strict <). Exact because zbest only falls: a slot
// whose running z lies above zbest cannot tie the final least z, and the
// state always holds the least (id, slot) among the slots at zbest.
//
// The hot loop only makes the strict improvements and notes that a tie
// happened. Ties are then settled at the end of the chunk, while it is still
// staged (tie_pass): for each pixel, the chunk's covered entries with z
// equal to the pixel's best z, other than the winner, are exactly the ties
// that still matter (an entry that lowered zbest in this chunk came before
// every entry that ties with it), and they are taken in list order under
// the rule (tie_take). The guard evaluates slot s's entries of the
// earlier chunks at that pixel again: the same expressions, so the same
// bits. Exact ties are rare on real inputs, and keeping their handling out
// of the entry loop keeps that loop's registers to K1's.
//
// The sign of a zero z: -0 and +0 tie, and the TPU kernel's cross-slot
// jnp.min orders -0 first, so its least z is -0 when any slot's running z
// is -0. The tie pass keeps that: a tie whose z is -0 and that is its
// slot's first at zero makes the best z -0, whoever wins. (The plain
// version's torch.amin leaves that sign to its reduction order.)
//
// The structure is K1's: each chunk's 13 scan words are staged in
// shared memory once per block, entry-major and padded to 16 words so a
// thread reads an entry's geometry as three float4 broadcasts; per-pixel
// state lives in registers; the winner's value planes are evaluated once at
// the end (plus +0, the sign of the TPU kernel's masked sum). A tile's
// pixels are split over blocks as K1's are (tile_scan::split_tile), so the
// 4,096-pixel tiles of workload 1 run as two or more blocks; a thread's
// pixels share a row (tile_scan::part_pixel), so each plane's ly*b is
// computed once per entry and a pixel costs an FMA and an add per plane.

// Whether slot s reached z at this pixel in a chunk before ci: one of its
// earlier entries covers it with z equal (-0 == +0, as the slot's strict <
// sees it).
__device__ __forceinline__ bool slot_reached(const float* co, int r, int k,
                                             int c, int s, int ci, float lx,
                                             float ly, float z) {
  for (int cj = 0; cj < ci; ++cj) {
    const int e = cj * c + s;
    if (e >= k) break;  // padding never covers
    const float ze = plane_vpu(coef_at(co, r, k, 0, 3, e),
                               coef_at(co, r, k, 1, 3, e),
                               coef_at(co, r, k, 2, 3, e), lx, ly);
    if (ze == z &&
        covers(plane_vpu(coef_at(co, r, k, 0, 0, e), coef_at(co, r, k, 1, 0, e),
                         coef_at(co, r, k, 2, 0, e), lx, ly),
               plane_vpu(coef_at(co, r, k, 0, 1, e), coef_at(co, r, k, 1, 1, e),
                         coef_at(co, r, k, 2, 1, e), lx, ly),
               plane_vpu(coef_at(co, r, k, 0, 2, e), coef_at(co, r, k, 1, 2, e),
                         coef_at(co, r, k, 2, 2, e), lx, ly),
               ze)) {
      return true;
    }
  }
  return false;
}

// Whether the covered entry e (chunk ci, slot s, id) whose z equals the
// pixel's best z is its slot's first at that z and so one of the slots the
// cross-slot reduction sees there, and whether it then replaces the winner w
// under K3's slot rule (w < 0: no winner yet, the best z is still its start,
// 1). The guard's re-evaluation runs only when one of the two needs it.
struct TieTake {
  bool first, replaces;
};
__device__ __forceinline__ TieTake tie_take(const float* co, int r, int k,
                                            int c, int e, float id, int w,
                                            float lx, float ly, float z,
                                            float zbest) {
  if (w < 0) return {true, true};
  const float idw = coef_at(co, r, k, 2, 4, w);
  const int s = e % c, sw = w % c;
  const bool better = id < idw || (id == idw && s < sw);
  const bool sign = __float_as_int(z) < 0 && __float_as_int(zbest) >= 0;
  if (!better && !sign) return {false, false};
  const bool first = !slot_reached(co, r, k, c, s, e / c, lx, ly, z);
  return {first, first && better};
}

// Settle one chunk's exact ties at each of a thread's pixels (see above).
// geo holds the chunk (entries e_base ..), staged.
template <int NG, bool kRow>
__device__ __forceinline__ void tie_pass(const float* co, const float* geo,
                                         int r, int k, int c, int e_base,
                                         const float* lx, const float* ly,
                                         float* zbest, int* win) {
  const float4* g4 = reinterpret_cast<const float4*>(geo);
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const float lyq = kRow ? ly[0] : ly[q];
    for (int j = 0; j < c; ++j) {
      const float4 r0 = g4[4 * j], r1 = g4[4 * j + 1], r2 = g4[4 * j + 2];
      const float z = plane_vpu(r2.y, r2.z, r2.w, lx[q], lyq);
      if (z == zbest[q] && win[q] != e_base + j &&
          covers(plane_vpu(r0.x, r0.y, r0.z, lx[q], lyq),
                 plane_vpu(r0.w, r1.x, r1.y, lx[q], lyq),
                 plane_vpu(r1.z, r1.w, r2.x, lx[q], lyq), z)) {
        const TieTake t = tie_take(co, r, k, c, e_base + j,
                                   geo[j * kStride + 12], win[q], lx[q],
                                   lyq, z, zbest[q]);
        if (t.replaces) win[q] = e_base + j;
        // The reduction's least z is -0 if any slot at zero holds -0.
        if (t.first && __float_as_int(z) < 0) zbest[q] = z;
      }
    }
  }
}

// One part of a tile: NG groups of pixels from p0 (tile_scan::part_pixel)
// over the tile's nch chunks.
template <int NG, bool kRow>
__device__ __forceinline__ void vpu_part(const ZattrArgs& a, float* geo,
                                         int tile, int nch, int p0) {
  const int c = a.d.c, k = a.d.k;
  const int r = 5 + a.n_vals;
  const int p_tile = a.d.tile_h * a.d.tile_w;
  const float* co = a.coeffs + static_cast<size_t>(tile) * 3 * r * k;

  // zbest starts at 1 with no winner, so "z <= zbest" also tests z <= 1; a
  // first covered z of exactly 1 takes the tie path, which accepts it.
  float lx[NG], ly[NG], zbest[NG];
  int win[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    pixel_centre(part_pixel<NG, kRow>(p0, q, a.d.tile_w), a.d.tile_w, lx[q],
                 ly[q]);
    zbest[q] = 1.f;
    win[q] = -1;
  }

  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = ci * c;
    stage_scan_words(geo, co, r, k, c, e_base);
    const float4* g4 = reinterpret_cast<const float4*>(geo);
    bool tie = false;
    for (int j = 0; j < c; ++j) {
      // [e0a e0b e0g e1a] [e1b e1g e2a e2b] [e2g za zb zg] [id - - -]
      const float4 r0 = g4[4 * j], r1 = g4[4 * j + 1], r2 = g4[4 * j + 2];
      // The b-terms ly * b, once per entry when the pixels share ly.
      const float h0 = __fmul_rn(ly[0], r0.y), h1 = __fmul_rn(ly[0], r1.x);
      const float h2 = __fmul_rn(ly[0], r1.w), hz = __fmul_rn(ly[0], r2.z);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float z = plane_vpu_by(r2.y, kRow ? hz : __fmul_rn(ly[q], r2.z),
                                     r2.w, lx[q]);
        const float e0 = plane_vpu_by(r0.x, kRow ? h0 : __fmul_rn(ly[q], r0.y),
                                      r0.z, lx[q]);
        const float e1 = plane_vpu_by(r0.w, kRow ? h1 : __fmul_rn(ly[q], r1.x),
                                      r1.y, lx[q]);
        const float e2 = plane_vpu_by(r1.z, kRow ? h2 : __fmul_rn(ly[q], r1.w),
                                      r2.x, lx[q]);
        if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= -1.f && z <= zbest[q]) {
          if (z < zbest[q]) {
            zbest[q] = z;
            win[q] = e_base + j;
          } else {
            tie = true;
          }
        }
      }
    }
    if (tie) tie_pass<NG, kRow>(co, geo, r, k, c, e_base, lx, ly, zbest, win);
  }

#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int p = part_pixel<NG, kRow>(p0, q, a.d.tile_w);
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(tile) * p_tile + p;
    const int w = win[q];
    const float lyq = kRow ? ly[0] : ly[q];
    a.z_out[o] = w >= 0 ? zbest[q] : inf_f();
    a.id_out[o] = w >= 0 ? coef_at(co, r, k, 2, 4, w) : kBackgroundId;
    for (int v = 0; v < a.n_vals; ++v) {
      float val = 0.f;
      if (w >= 0) {
        val = __fadd_rn(plane_vpu(coef_at(co, r, k, 0, 5 + v, w),
                                  coef_at(co, r, k, 1, 5 + v, w),
                                  coef_at(co, r, k, 2, 5 + v, w), lx[q], lyq),
                        0.f);
      }
      a.v_out[(static_cast<size_t>(tile) * a.n_vals + v) * p_tile + p] = val;
    }
  }
}

// Grid (max_parts * n_tiles), as tile_scan::run_part lays it out.
template <bool kRow>
__global__ void __launch_bounds__(kThreads) zattr_vpu_kernel(ZattrArgs a) {
  extern __shared__ __align__(16) float geo[];  // [c][16]
  run_part(a.counts, a.d, [&](auto ng_c, int tile, int nch, int p0) {
    vpu_part<decltype(ng_c)::value, kRow>(a, geo, tile, nch, p0);
  });
}

using KernelFn = void (*)(ZattrArgs);

// K2's instance for a tile width: a thread's pixels in one column when it
// allows.
KernelFn dot_kernel_for(int tile_w) {
  return column_mapping(tile_w) ? zattr_kernel<true> : zattr_kernel<false>;
}

// K3's: a thread's pixels in one row when it allows.
KernelFn vpu_kernel_for(int tile_w) {
  return row_mapping(tile_w) ? zattr_vpu_kernel<true> : zattr_vpu_kernel<false>;
}

size_t smem_bytes(int c) {
  return static_cast<size_t>(kStride) * c * sizeof(float);
}

// Launch `kernel` over max_parts * n_tiles blocks on `stream`
// (tile_scan::launch_parts); 0 on success or a CUDA error,
// cudaErrorInvalidValue for shapes the kernels do not take (an empty grid,
// a chunk whose staged words exceed 48 KB of shared memory).
int launch(KernelFn kernel, const void* coeffs, const void* counts,
           void* z_out, void* id_out, void* v_out, int n_tiles, int k,
           int n_vals, int tile_h, int tile_w, int c, void* stream) {
  if (n_tiles <= 0 || k <= 0 || n_vals <= 0 || tile_h <= 0 || tile_w <= 0 ||
      c <= 0 || smem_bytes(c) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ZattrArgs a{static_cast<const float*>(coeffs), static_cast<const int*>(counts),
              static_cast<float*>(z_out), static_cast<float*>(id_out),
              static_cast<float*>(v_out), n_vals,
              {n_tiles, k, tile_h, tile_w, c}};
  return launch_parts(kernel, a, smem_bytes(c), stream);
}

}  // namespace

// Launch K2 on `stream` (outputs as documented above); a tile of any size
// splits into groups of kThreads pixels. Returns 0 on success or a CUDA
// error; cudaErrorInvalidValue for shapes it does not take.
extern "C" int zattr_tiles_launch(const void* coeffs, const void* counts,
                                  void* z_out, void* id_out, void* v_out,
                                  int n_tiles, int k, int n_vals, int tile_h,
                                  int tile_w, int c, void* stream) {
  return launch(dot_kernel_for(tile_w), coeffs, counts, z_out, id_out, v_out,
                n_tiles, k, n_vals, tile_h, tile_w, c, stream);
}

// Launch K3 on `stream` (outputs as documented above). c must be 128 or 256
// (the slot of an entry is its index mod c); a tile of any size splits into
// groups of kThreads pixels. Returns 0 on success or a CUDA error;
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int zattr_tiles_vpu_launch(const void* coeffs, const void* counts,
                                      void* z_out, void* id_out, void* v_out,
                                      int n_tiles, int k, int n_vals,
                                      int tile_h, int tile_w, int c,
                                      void* stream) {
  if (c != 128 && c != 256) return static_cast<int>(cudaErrorInvalidValue);
  return launch(vpu_kernel_for(tile_w), coeffs, counts, z_out, id_out, v_out,
                n_tiles, k, n_vals, tile_h, tile_w, c, stream);
}

// K2's and K3's resources at chunk size c and tile width tile_w: registers
// per thread, shared memory per block (bytes, static + dynamic) and resident
// blocks per SM. Return 0 or a CUDA error.
extern "C" int zattr_tiles_occupancy(int c, int tile_w, int* regs, int* smem,
                                     int* blocks_per_sm) {
  return kernel_occupancy(dot_kernel_for(tile_w), smem_bytes(c), regs, smem,
                          blocks_per_sm);
}

extern "C" int zattr_tiles_vpu_occupancy(int c, int tile_w, int* regs,
                                         int* smem, int* blocks_per_sm) {
  return kernel_occupancy(vpu_kernel_for(tile_w), smem_bytes(c), regs, smem,
                          blocks_per_sm);
}
