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
// entries of least z, those of the first chunk that reaches it, and among
// those the least id. Its value planes are that entry's. A tile's entries
// carry distinct ids (the binning lists a triangle once per tile), so the
// TPU kernels' masked sum over winners is the one winner's value; a zero
// sum is +0, which the kernels reproduce by adding +0.
//
// What bounds them: fp32 arithmetic. Every (entry, pixel) pair costs four
// plane evaluations (a multiply, an FMA and an add each) and six compares;
// an entry's 13 geometry and id words serve every pixel of the tile.
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

// ---- K3: per-lane-slot running buffers, then a cross-slot reduction. ----
//
// K3's formulation: a thread block per tile holds c slots x G pixel groups
// (kThreads threads). Slot s scans entries s, s + c, s + 2c, ... (the s-th
// lane of every chunk) and keeps, for each of its kVpuPpt pixels, a running
// z, id and entry with a strict z < zrun, the TPU kernel's per-lane running
// buffers; the running values are those of the running entry, evaluated
// once at the end (the same bits). Pixels go in sub-blocks of G * kVpuPpt,
// K3's sub_p, which bounds that state. After the scan the block reduces
// across the c slots in shared memory: least z, then least id among them,
// then the winner's values. Coefficients are read straight from device
// memory: neighbouring slots read neighbouring words.
constexpr int kVpuPpt = 8;
constexpr int kMaxSubPixels = 2 * kVpuPpt;  // G <= 2 (c >= 128)

__global__ void __launch_bounds__(kThreads)
    zattr_vpu_kernel(const float* __restrict__ coeffs,
                     const int* __restrict__ counts, float* __restrict__ z_out,
                     float* __restrict__ id_out, float* __restrict__ v_out,
                     int k, int n_vals, int tile_h, int tile_w, int c) {
  __shared__ float s_z[kMaxSubPixels * kThreads / 2];
  __shared__ float s_id[kMaxSubPixels * kThreads / 2];
  __shared__ int s_ent[kMaxSubPixels * kThreads / 2];
  const int tile = blockIdx.x;
  const int p_tile = tile_h * tile_w;
  const int r = 5 + n_vals;
  const float* co = coeffs + static_cast<size_t>(tile) * 3 * r * k;
  const int count = min(max(counts[tile], 0), k);
  const int nch = (count + c - 1) / c;
  const int groups = blockDim.x / c;
  const int slot = threadIdx.x % c;
  const int grp = threadIdx.x / c;
  const int sub_p = groups * kVpuPpt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int p0 = 0; p0 < p_tile; p0 += sub_p) {
    float lx[kVpuPpt], ly[kVpuPpt], zrun[kVpuPpt], idrun[kVpuPpt];
    int ent[kVpuPpt];
#pragma unroll
    for (int q = 0; q < kVpuPpt; ++q) {
      pixel_centre(p0 + grp * kVpuPpt + q, tile_w, lx[q], ly[q]);
      zrun[q] = inf_f();
      idrun[q] = kBackgroundId;
      ent[q] = -1;
    }
    for (int ci = 0; ci < nch; ++ci) {
      const int e = ci * c + slot;
      if (e >= k) continue;  // padding never covers
      const float e0a = co[(0 * r + 0) * static_cast<size_t>(k) + e];
      const float e0b = co[(1 * r + 0) * static_cast<size_t>(k) + e];
      const float e0g = co[(2 * r + 0) * static_cast<size_t>(k) + e];
      const float e1a = co[(0 * r + 1) * static_cast<size_t>(k) + e];
      const float e1b = co[(1 * r + 1) * static_cast<size_t>(k) + e];
      const float e1g = co[(2 * r + 1) * static_cast<size_t>(k) + e];
      const float e2a = co[(0 * r + 2) * static_cast<size_t>(k) + e];
      const float e2b = co[(1 * r + 2) * static_cast<size_t>(k) + e];
      const float e2g = co[(2 * r + 2) * static_cast<size_t>(k) + e];
      const float za = co[(0 * r + 3) * static_cast<size_t>(k) + e];
      const float zb = co[(1 * r + 3) * static_cast<size_t>(k) + e];
      const float zg = co[(2 * r + 3) * static_cast<size_t>(k) + e];
      const float id = co[(2 * r + 4) * static_cast<size_t>(k) + e];
#pragma unroll
      for (int q = 0; q < kVpuPpt; ++q) {
        const float z = plane_vpu(za, zb, zg, lx[q], ly[q]);
        if (covers(plane_vpu(e0a, e0b, e0g, lx[q], ly[q]),
                   plane_vpu(e1a, e1b, e1g, lx[q], ly[q]),
                   plane_vpu(e2a, e2b, e2g, lx[q], ly[q]), z) &&
            z < zrun[q]) {
          zrun[q] = z;
          idrun[q] = id;
          ent[q] = e;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kVpuPpt; ++q) {
      const int i = (grp * kVpuPpt + q) * c + slot;
      s_z[i] = zrun[q];
      s_id[i] = idrun[q];
      s_ent[i] = ent[q];
    }
    __syncthreads();
    // Cross-slot reduction, one warp per pixel of the sub-block.
    for (int lp = warp; lp < sub_p; lp += n_warps) {
      const int p = p0 + lp;
      const float* zz = s_z + lp * c;
      const float* ii = s_id + lp * c;
      float zmin = inf_f();
      for (int s = lane; s < c; s += 32) zmin = fminf(zmin, zz[s]);
      for (int o = 16; o > 0; o >>= 1)
        zmin = fminf(zmin, __shfl_xor_sync(0xffffffffu, zmin, o));
      float idmin = kBackgroundId;
      for (int s = lane; s < c; s += 32)
        if (zz[s] == zmin) idmin = fminf(idmin, ii[s]);
      for (int o = 16; o > 0; o >>= 1)
        idmin = fminf(idmin, __shfl_xor_sync(0xffffffffu, idmin, o));
      int wslot = c;
      for (int s = lane; s < c; s += 32)
        if (zz[s] == zmin && ii[s] == idmin) wslot = min(wslot, s);
      for (int o = 16; o > 0; o >>= 1)
        wslot = min(wslot, __shfl_xor_sync(0xffffffffu, wslot, o));
      if (p >= p_tile) continue;
      const size_t o = static_cast<size_t>(tile) * p_tile + p;
      const bool covered = zmin != inf_f();
      const int w = covered ? s_ent[lp * c + wslot] : -1;
      float plx, ply;
      pixel_centre(p, tile_w, plx, ply);
      for (int v = lane; v < n_vals; v += 32) {
        float val = 0.f;
        if (w >= 0) {
          val = __fadd_rn(plane_vpu(coef_at(co, r, k, 0, 5 + v, w),
                                    coef_at(co, r, k, 1, 5 + v, w),
                                    coef_at(co, r, k, 2, 5 + v, w), plx, ply),
                          0.f);
        }
        v_out[(static_cast<size_t>(tile) * n_vals + v) * p_tile + p] = val;
      }
      if (lane == 0) {
        z_out[o] = zmin;
        id_out[o] = covered ? idmin : kBackgroundId;
      }
    }
    __syncthreads();  // the shared buffers are reused by the next sub-block
  }
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
// (one slot per thread, kThreads / c pixel groups). Returns
// cudaGetLastError() after the launch (0 on success); cudaErrorInvalidValue
// for shapes it does not take.
extern "C" int zattr_tiles_vpu_launch(const void* coeffs, const void* counts,
                                      void* z_out, void* id_out, void* v_out,
                                      int n_tiles, int k, int n_vals,
                                      int tile_h, int tile_w, int c,
                                      void* stream) {
  if (!check_shapes(n_tiles, k, n_vals, tile_h, tile_w, c) ||
      (c != 128 && c != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  zattr_vpu_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const int*>(counts),
      static_cast<float*>(z_out), static_cast<float*>(id_out),
      static_cast<float*>(v_out), k, n_vals, tile_h, tile_w, c);
  return static_cast<int>(cudaGetLastError());
}
