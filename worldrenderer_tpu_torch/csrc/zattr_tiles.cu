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
// plane evaluations and five or six compares: in K2 a multiply, an FMA and
// an add each; in K3, whose ly*b is shared along a row, an FMA and an add.
// An entry's 13 geometry and id words serve every pixel of the tile. Both
// keep the pair loop free of device-memory traffic: a chunk's scan words in
// shared memory, per-pixel state in registers.
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
constexpr float kBackgroundId = 1073741824.f;  // 2^30

// Coefficient `coef` of block `blk` of entry e; the padding past k is the
// TPU wrappers' edge0_pad_block (zero but e0 g = -3e38).
__device__ __forceinline__ float coef_at(const float* co, int r, int k,
                                         int coef, int blk, int e) {
  if (e >= k) return (coef == 2 && blk == 0) ? kBigNeg : 0.f;
  return co[(static_cast<size_t>(coef) * r + blk) * k + e];
}

// ---- K2: one thread block per tile, a sequential scan per pixel. --------
//
// Each chunk's 13 scan words per entry are staged in shared memory once and
// read as broadcasts; each thread keeps its PPT pixels' best z, id, chunk
// and entry in registers, and evaluates only the winner's value planes at
// the end. The sequential scan keeps K2's rule: an entry replaces the best
// when its z is smaller, or equal with a smaller id within the same chunk.
template <int PPT>
__global__ void __launch_bounds__(kThreads)
    zattr_kernel(const float* __restrict__ coeffs,
                 const int* __restrict__ counts, float* __restrict__ z_out,
                 float* __restrict__ id_out, float* __restrict__ v_out, int k,
                 int n_vals, int tile_h, int tile_w, int c) {
  extern __shared__ float geo[];  // [kScanRows][c], row = block * 3 + coef
  const int tile = blockIdx.x;
  const int p_tile = tile_h * tile_w;
  const int r = 5 + n_vals;
  const float* co = coeffs + static_cast<size_t>(tile) * 3 * r * k;
  const int count = min(max(counts[tile], 0), k);
  const int nch = (count + c - 1) / c;

  float lx[PPT], ly[PPT], zbest[PPT], idbest[PPT];
  int cbest[PPT], win[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    pixel_centre(threadIdx.x + q * kThreads, tile_w, lx[q], ly[q]);
    zbest[q] = inf_f();
    idbest[q] = kBackgroundId;
    cbest[q] = -1;
    win[q] = -1;
  }

  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = ci * c;
    stage_chunk(geo, kScanRows, c, [&](int row, int j) {
      const int blk = row / 3, coef = row - blk * 3;
      // row 12 is the id block's g (block 4, coef 2)
      return row < 12 ? coef_at(co, r, k, coef, blk, e_base + j)
                      : coef_at(co, r, k, 2, 4, e_base + j);
    });
    for (int j = 0; j < c; ++j) {
      const float e0a = geo[0 * c + j], e0b = geo[1 * c + j], e0g = geo[2 * c + j];
      const float e1a = geo[3 * c + j], e1b = geo[4 * c + j], e1g = geo[5 * c + j];
      const float e2a = geo[6 * c + j], e2b = geo[7 * c + j], e2g = geo[8 * c + j];
      const float za = geo[9 * c + j], zb = geo[10 * c + j], zg = geo[11 * c + j];
      const float id = geo[12 * c + j];
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float z = plane_dot(za, zb, zg, lx[q], ly[q]);
        const bool cov = covers(plane_dot(e0a, e0b, e0g, lx[q], ly[q]),
                                plane_dot(e1a, e1b, e1g, lx[q], ly[q]),
                                plane_dot(e2a, e2b, e2g, lx[q], ly[q]), z);
        if (cov && (z < zbest[q] ||
                    (z == zbest[q] && cbest[q] == ci && id < idbest[q]))) {
          zbest[q] = z;
          idbest[q] = id;
          cbest[q] = ci;
          win[q] = e_base + j;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * kThreads;
    if (p >= p_tile) continue;
    const size_t o = static_cast<size_t>(tile) * p_tile + p;
    const int w = win[q];
    z_out[o] = zbest[q];
    id_out[o] = idbest[q];
    for (int v = 0; v < n_vals; ++v) {
      float val = 0.f;
      if (w >= 0) {
        val = __fadd_rn(plane_dot(coef_at(co, r, k, 0, 5 + v, w),
                                  coef_at(co, r, k, 1, 5 + v, w),
                                  coef_at(co, r, k, 2, 5 + v, w), lx[q], ly[q]),
                        0.f);
      }
      v_out[(static_cast<size_t>(tile) * n_vals + v) * p_tile + p] = val;
    }
  }
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
// The structure is K2's and K1's: each chunk's 13 scan words are staged in
// shared memory once per block, entry-major and padded to 16 words so a
// thread reads an entry's geometry as three float4 broadcasts; per-pixel
// state lives in registers; the winner's value planes are evaluated once at
// the end (plus +0, the sign of the TPU kernel's masked sum). A tile's
// pixels are split over blocks as K1's are (tile_scan::split_tile), so the
// 4,096-pixel tiles of workload 1 run as two or more blocks; a thread's
// pixels share a row (tile_scan::part_pixel), so each plane's ly*b is
// computed once per entry and a pixel costs an FMA and an add per plane.
constexpr int kVpuStride = 16;  // words per staged entry: 13 used

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
                                   geo[j * kVpuStride + 12], win[q], lx[q],
                                   lyq, z, zbest[q]);
        if (t.replaces) win[q] = e_base + j;
        // The reduction's least z is -0 if any slot at zero holds -0.
        if (t.first && __float_as_int(z) < 0) zbest[q] = z;
      }
    }
  }
}

struct K3Args {
  const float* coeffs;
  const int* counts;
  float* z_out;
  float* id_out;
  float* v_out;
  int n_tiles, k, n_vals, tile_h, tile_w, c, groups, max_parts;
};

// One part of a tile: NG groups of pixels from p0 (tile_scan::part_pixel)
// over the tile's nch chunks.
template <int NG, bool kRow>
__device__ __forceinline__ void vpu_part(const K3Args& a, float* geo,
                                         int tile, int nch, int p0) {
  const int c = a.c, k = a.k;
  const int r = 5 + a.n_vals;
  const int p_tile = a.tile_h * a.tile_w;
  const float* co = a.coeffs + static_cast<size_t>(tile) * 3 * r * k;

  // zbest starts at 1 with no winner, so "z <= zbest" also tests z <= 1; a
  // first covered z of exactly 1 takes the tie path, which accepts it.
  float lx[NG], ly[NG], zbest[NG];
  int win[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    pixel_centre(part_pixel<NG, kRow>(p0, q, a.tile_w), a.tile_w, lx[q], ly[q]);
    zbest[q] = 1.f;
    win[q] = -1;
  }

  for (int ci = 0; ci < nch; ++ci) {
    const int e_base = ci * c;
    // geo[j * 16 + row], row = block * 3 + coef for the four geometry
    // blocks, row 12 the id block's g (block 4, coef 2).
    __syncthreads();  // no thread still reads the previous chunk
    for (int i = threadIdx.x; i < kScanRows * c; i += kThreads) {
      const int row = i / c, j = i - row * c;
      const int blk = row < 12 ? row / 3 : 4;
      const int coef = row < 12 ? row - blk * 3 : 2;
      geo[j * kVpuStride + row] = coef_at(co, r, k, coef, blk, e_base + j);
    }
    __syncthreads();
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
    const int p = part_pixel<NG, kRow>(p0, q, a.tile_w);
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

// Grid (max_parts * n_tiles): block x = (max_parts - 1 - part) * n_tiles +
// tile, the highest parts first as in K1. max_parts is the split of a full
// list of k entries, which no tile exceeds.
template <bool kRow>
__global__ void __launch_bounds__(kThreads) zattr_vpu_kernel(K3Args a) {
  extern __shared__ __align__(16) float geo[];  // [c][16]
  const int tile = blockIdx.x % a.n_tiles;
  const int part = a.max_parts - 1 - static_cast<int>(blockIdx.x) / a.n_tiles;
  const int count = min(max(a.counts[tile], 0), a.k);
  const int nch = (count + a.c - 1) / a.c;
  const TileSplit split = split_tile(a.groups, nch);
  if (part >= split.parts) return;  // the tile needs fewer blocks
  const int p0 = part * split.ng * kThreads;
  dispatch_groups(split.ng, [&](auto ng_c) {
    vpu_part<decltype(ng_c)::value, kRow>(a, geo, tile, nch, p0);
  });
}

using VpuKernelFn = void (*)(K3Args);
VpuKernelFn vpu_kernel_for(int tile_w) {
  return row_mapping(tile_w) ? zattr_vpu_kernel<true> : zattr_vpu_kernel<false>;
}

size_t vpu_smem_bytes(int c) {
  return static_cast<size_t>(kVpuStride) * c * sizeof(float);
}

int check_shapes(int n_tiles, int k, int n_vals, int tile_h, int tile_w,
                 int c) {
  return n_tiles > 0 && k > 0 && n_vals > 0 && tile_h > 0 && tile_w > 0 &&
         c > 0;
}

}  // namespace

// Launch K2 on `stream` (outputs as documented above). Returns
// cudaGetLastError() after the launch (0 on success); cudaErrorInvalidValue
// for shapes it does not take (a tile of more than 16 * 256 pixels, a chunk
// whose scan words exceed 48 KB of shared memory, an empty grid).
extern "C" int zattr_tiles_launch(const void* coeffs, const void* counts,
                                  void* z_out, void* id_out, void* v_out,
                                  int n_tiles, int k, int n_vals, int tile_h,
                                  int tile_w, int c, void* stream) {
  const size_t smem = static_cast<size_t>(kScanRows) * c * sizeof(float);
  if (!check_shapes(n_tiles, k, n_vals, tile_h, tile_w, c) ||
      smem > 48 * 1024 || pixels_per_thread(tile_h * tile_w) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* co = static_cast<const float*>(coeffs);
  auto* cn = static_cast<const int*>(counts);
  auto* zo = static_cast<float*>(z_out);
  auto* io = static_cast<float*>(id_out);
  auto* vo = static_cast<float*>(v_out);
  return static_cast<int>(
      dispatch_ppt(pixels_per_thread(tile_h * tile_w), [&](auto ppt_c) {
        constexpr int kPpt = decltype(ppt_c)::value;
        zattr_kernel<kPpt><<<n_tiles, kThreads, smem, s>>>(
            co, cn, zo, io, vo, k, n_vals, tile_h, tile_w, c);
        return cudaGetLastError();
      }));
}

// Launch K3 on `stream` (outputs as documented above). c must be 128 or 256
// (the slot of an entry is its index mod c); a tile of any size splits into
// groups of kThreads pixels. Returns cudaGetLastError() after the launch (0
// on success); cudaErrorInvalidValue for shapes it does not take.
extern "C" int zattr_tiles_vpu_launch(const void* coeffs, const void* counts,
                                      void* z_out, void* id_out, void* v_out,
                                      int n_tiles, int k, int n_vals,
                                      int tile_h, int tile_w, int c,
                                      void* stream) {
  if (!check_shapes(n_tiles, k, n_vals, tile_h, tile_w, c) ||
      (c != 128 && c != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (tile_h * tile_w + kThreads - 1) / kThreads;
  const int max_parts = split_tile(groups, (k + c - 1) / c).parts;
  K3Args a{static_cast<const float*>(coeffs), static_cast<const int*>(counts),
           static_cast<float*>(z_out), static_cast<float*>(id_out),
           static_cast<float*>(v_out), n_tiles, k, n_vals, tile_h, tile_w, c,
           groups, max_parts};
  vpu_kernel_for(tile_w)<<<max_parts * n_tiles, kThreads, vpu_smem_bytes(c),
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3's resources at chunk size c and tile width tile_w: registers per
// thread, shared memory per block (bytes, static + dynamic) and resident
// blocks per SM. Returns 0 or a CUDA error.
extern "C" int zattr_tiles_vpu_occupancy(int c, int tile_w, int* regs,
                                         int* smem, int* blocks_per_sm) {
  const VpuKernelFn kernel = vpu_kernel_for(tile_w);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + vpu_smem_bytes(c));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, vpu_smem_bytes(c)));
}
