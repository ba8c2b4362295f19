// P3: the in-shared-memory gather probe on Hopper.
//
// Replaces tools/probe_vmem_gather.py:30 probe_pallas (kernel body kernel,
// :35): T repetitions of acc += take_along_axis(x, (idx0 + i) mod M, axis)
// over x, idx0 (R, 128), M = R for axis 0 and 128 for axis 1. On the TPU it
// measures Mosaic's in-VMEM dynamic gather, the candidate primitive of a
// windowed texture sampler; here the window lives in shared memory and the
// gather is a shared-memory load per element.
//
// What bounds it: shared-memory bandwidth, T * R * 128 four-byte loads at
// 32 banks * 4 bytes per clock per SM (the index and output traffic to
// device memory is R * 128 * 12 bytes, once). So the design keeps every
// warp's loads in distinct banks, spends no integer division in the loop,
// and fills every SM:
//
//   The loop. A thread's element walks its gathered line (a row of x for
//   axis 1, a column for axis 0) from j0 = idx0 mod M, one element a step,
//   wrapping at M. The staged line carries a copy of its first kW elements
//   after its end (element M + k holds element k mod M), so kW steps from
//   any j < M never wrap: a group of kW loads at immediate offsets, all
//   issued before the kW adds, then one compare-and-subtract of j. The only
//   division is the floor mod of idx0, once per element.
//
//   axis 1 (y[r, l] = x[r, j]). A block stages kRows1 = 32 whole rows,
//   transposed (xs[m * 32 + r]), and owns a 32 x 32 tile of outputs: lane
//   r of warp w computes (r0 + r, c0 + w). A warp's 32 loads read 32
//   rows, each in its own bank, whatever the indices. Indices come in and
//   outputs go out through a padded shared tile, so device memory sees
//   coalesced rows. 256 blocks of 1,024 threads, two per SM.
//
//   axis 0 (y[r, l] = x[j, l]). A block stages kCols0 = 16 whole columns
//   (xc[m * 16 + c], R * 64 bytes: 128 KB at R = 2048, so one block per SM
//   and the launch raises the dynamic shared-memory limit) and owns a band
//   of kBand0 = 128 rows of them, two elements a thread of 1,024 (as many
//   warps as an SM holding one block can take; 512 threads of four
//   elements read 11% slower). Element (j, c)
//   lies in bank c + 16 (j mod 2): the two lanes of a warp that share a
//   column collide only when their j have one parity. So each column's
//   elements are paired before the loop, an even j0 with an odd one
//   (evens listed from the front, odds from the back), and the pair goes to
//   the two lanes; with R even a pair keeps its parities through every
//   step. Only the excess of one parity in a column pairs like with like.
//   The column slab arrives by cp.async while the pairing runs. 128 blocks.
//
// Bits: each element's T adds run in i order from +0, the plain version's
// order (probes/smem_gather.py), so the two agree bit for bit; which
// thread computes an element does not change its sum.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kW = 16;        // loads per group; copied elements after a line
constexpr int kRows1 = 32;    // axis 1: rows per block (a warp's lanes)
constexpr int kCols1 = 32;    // axis 1: output columns per block (its warps)
constexpr int kThreads1 = kRows1 * kCols1;
constexpr int kCols0 = 16;    // axis 0: columns per block
constexpr int kBand0 = 128;   // axis 0: output rows per block
constexpr int kThreads0 = 1024;
constexpr int kPer0 = kBand0 * kCols0 / kThreads0;  // elements per thread

// Bytes of axis 0's dynamic shared memory at R rows: the column slab with
// its copied rows, the pair lists (padded rows) and the output tile.
size_t axis0_smem(int rows) {
  return (static_cast<size_t>(rows + kW) * kCols0 + kCols0 * (kBand0 + 1) +
          kBand0 * (kCols0 + 1)) * sizeof(float);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The sums of N elements in lockstep: element e adds line[e][(j[e] + i) mod
// m], i < t_reps, in i order from +0, where line[e][k * S] is its k-th
// element, k < m + kW (the last kW copy the first). j[e] in [0, m).
template <int S, int N>
__device__ __forceinline__ void wrap_sums(const float* (&line)[N],
                                          int (&j)[N], int m, int t_reps,
                                          float (&acc)[N]) {
  const int step = kW % m;
  int i = 0;
  for (; i + kW <= t_reps; i += kW) {
    float v[N][kW];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float* p = line[e] + j[e] * S;
#pragma unroll
      for (int k = 0; k < kW; ++k) v[e][k] = p[k * S];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
#pragma unroll
      for (int k = 0; k < kW; ++k) acc[e] = __fadd_rn(acc[e], v[e][k]);
      j[e] += step;
      if (j[e] >= m) j[e] -= m;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float* p = line[e] + j[e] * S;
    for (int k = 0; k < t_reps - i; ++k) acc[e] = __fadd_rn(acc[e], p[k * S]);
  }
}

__global__ void __launch_bounds__(kThreads1)
    gather_axis1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ out, int rows, int t_reps) {
  __shared__ float xs[(kLanes + kW) * kRows1];  // [m][row]
  __shared__ int io[kRows1 * (kCols1 + 1)];     // indices in, sums out
  const int r0 = blockIdx.y * kRows1;
  const int c0 = blockIdx.x * kCols1;
  const int n_rows = min(kRows1, rows - r0);
  const int t = threadIdx.x;
  {  // x: one float4 of one row per thread, stored down the row's bank
    const int r = t & 31, q = t >> 5;
    if (r < n_rows) {
      const float4 v =
          reinterpret_cast<const float4*>(x + static_cast<size_t>(r0 + r) * kLanes)[q];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xs[(4 * q + k) * kRows1 + r] = vals[k];
        if (4 * q + k < kW) xs[(kLanes + 4 * q + k) * kRows1 + r] = vals[k];
      }
    }
    const int row = t >> 5, col = t & 31;  // indices: coalesced rows
    if (row < n_rows) {
      io[row * (kCols1 + 1) + col] = idx[static_cast<size_t>(r0 + row) * kLanes + c0 + col];
    }
  }
  __syncthreads();
  const int r = t & 31, c = t >> 5;
  float acc[1] = {0.f};
  if (r < n_rows) {
    const float* line[1] = {xs + r};
    int j[1] = {io[r * (kCols1 + 1) + c] & (kLanes - 1)};  // floor mod 128
    wrap_sums<kRows1, 1>(line, j, kLanes, t_reps, acc);
  }
  __syncthreads();  // every index read before the tile takes sums
  if (r < n_rows) io[r * (kCols1 + 1) + c] = __float_as_int(acc[0]);
  __syncthreads();
  const int row = t >> 5, col = t & 31;
  if (row < n_rows) {
    out[static_cast<size_t>(r0 + row) * kLanes + c0 + col] =
        __int_as_float(io[row * (kCols1 + 1) + col]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__global__ void __launch_bounds__(kThreads0)
    gather_axis0_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ out, int rows, int t_reps) {
  extern __shared__ __align__(16) float smem[];
  float* xc = smem;                                              // [m][col]
  int* pairs = reinterpret_cast<int*>(xc + (rows + kW) * kCols0);  // [col][slot]
  float* tile = reinterpret_cast<float*>(pairs + kCols0 * (kBand0 + 1));
  __shared__ int n_even[kCols0], n_odd[kCols0];
  const int c0 = blockIdx.x * kCols0;
  const int band0 = blockIdx.y * kBand0;
  const int n = min(kBand0, rows - band0);  // rows of the band
  const int t = threadIdx.x;

  // The column slab, rows + kW rows of 4 sixteen-byte pieces, in flight
  // while the pairs are made.
  for (int i = t; i < (rows + kW) * (kCols0 / 4); i += kThreads0) {
    const int m = i / (kCols0 / 4), q = i - m * (kCols0 / 4);
    const int src = m < rows ? m : (m - rows) % rows;
    cp_async16(xc + m * kCols0 + 4 * q, x + static_cast<size_t>(src) * kLanes + c0 + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (t < kCols0) n_even[t] = n_odd[t] = 0;
  __syncthreads();
  // Pairs: column col lists its even j0 from slot 0 up and its odd ones
  // from slot n - 1 down; an entry is j0 * kBand0 + row.
#pragma unroll
  for (int k = 0; k < kPer0; ++k) {
    const int e = t + k * kThreads0;
    const int row = e / kCols0, col = e - row * kCols0;
    if (row < n) {
      const int j0 = floor_mod(idx[static_cast<size_t>(band0 + row) * kLanes + c0 + col], rows);
      const int slot = (j0 & 1) ? n - 1 - atomicAdd(&n_odd[col], 1)
                                 : atomicAdd(&n_even[col], 1);
      pairs[col * (kBand0 + 1) + slot] = j0 * kBand0 + row;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // Lane (col, h) of warp w takes, for k < kPer0, pair p = kPer0 * w + k:
  // list entry p (h = 0) or n - 1 - p (h = 1).
  const int col = t & (kCols0 - 1), h = (t >> 4) & 1, w = t >> 5;
  const float* line[kPer0];
  int j[kPer0], row[kPer0];
  bool live[kPer0];
  float acc[kPer0];
#pragma unroll
  for (int k = 0; k < kPer0; ++k) {
    const int p = kPer0 * w + k;
    const int s = h ? n - 1 - p : p;
    live[k] = h ? p < n / 2 : p < (n + 1) / 2;
    const int entry = live[k] ? pairs[col * (kBand0 + 1) + s] : 0;
    j[k] = entry / kBand0;
    row[k] = entry - j[k] * kBand0;
    line[k] = xc + col;
    acc[k] = 0.f;
  }
  wrap_sums<kCols0, kPer0>(line, j, rows, t_reps, acc);
#pragma unroll
  for (int k = 0; k < kPer0; ++k) {
    if (live[k]) tile[row[k] * (kCols0 + 1) + col] = acc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer0; ++k) {
    const int e = t + k * kThreads0;
    const int r = e / kCols0, c = e - r * kCols0;
    if (r < n) {
      out[static_cast<size_t>(band0 + r) * kLanes + c0 + c] = tile[r * (kCols0 + 1) + c];
    }
  }
}

}  // namespace

// Launch P3 on `stream` over x, idx (rows, 128); x must be 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for shapes it does not take (axis not 0 or 1, an
// empty grid, an axis-0 column slab above the card's shared memory per
// block).
extern "C" int smem_gather_launch(const void* x, const void* idx, void* out,
                                  int rows, int t_reps, int axis,
                                  void* stream) {
  if (rows <= 0 || t_reps < 0 || (axis != 0 && axis != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* ip = static_cast<const int*>(idx);
  auto* op = static_cast<float*>(out);
  if (axis == 1) {
    const dim3 grid(kLanes / kCols1, (rows + kRows1 - 1) / kRows1);
    gather_axis1_kernel<<<grid, kThreads1, 0, s>>>(xp, ip, op, rows, t_reps);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = axis0_smem(rows);
  cudaError_t err = cudaFuncSetAttribute(
      gather_axis0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kLanes / kCols0, (rows + kBand0 - 1) / kBand0);
  gather_axis0_kernel<<<grid, kThreads0, smem, s>>>(xp, ip, op, rows, t_reps);
  return static_cast<int>(cudaGetLastError());
}

// Each axis's kernel at R rows: registers per thread, shared memory per
// block (bytes) and resident blocks per SM on the current card.
extern "C" int smem_gather_occupancy(int axis, int rows, int* regs, int* smem,
                                     int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const void* fn = axis == 1 ? reinterpret_cast<const void*>(gather_axis1_kernel)
                             : reinterpret_cast<const void*>(gather_axis0_kernel);
  const size_t dyn = axis == 1 ? 0 : axis0_smem(rows);
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (axis == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dyn);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, axis == 1 ? kThreads1 : kThreads0, dyn));
}
