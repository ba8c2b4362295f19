// P3: the in-shared-memory gather probe on Hopper.
//
// Replaces tools/probe_vmem_gather.py:30 probe_pallas (kernel body kernel,
// :35): T repetitions of acc += take_along_axis(x, (idx0 + i) mod M, axis)
// over x, idx0 (R, 128), M = R for axis 0 and 128 for axis 1. On the TPU it
// measures Mosaic's in-VMEM dynamic gather, the candidate primitive of a
// windowed texture sampler; here the window lives in shared memory and the
// gather is a shared-memory load per element.
//
//   axis 1 (y[r, l] = x[r, j]): a block stages kRows1 whole rows of x and
//     owns their outputs.
//   axis 0 (y[r, l] = x[j, l]): a block stages kCols0 columns of x over
//     every row (R * kCols0 * 4 bytes: 64 KB at R = 2048, above the 48 KB a
//     block gets without opting in, so the launch raises the limit with
//     cudaFuncSetAttribute) and owns a band of rows of those columns.
//
// What bounds it: shared-memory bandwidth, T * R * 128 four-byte loads at
// 32 banks * 4 bytes per clock per SM (the index and output traffic to
// device memory is R * 128 * 12 bytes, once).
//
// Bits: each element's T adds run in i order from +0, the plain version's
// order (probes/smem_gather.py), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kRows1 = 16;   // axis 1: rows per block
constexpr int kCols0 = 8;    // axis 0: columns per block
constexpr int kBands0 = 8;   // axis 0: row bands per column group

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kThreads)
    gather_axis1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ out, int rows, int t_reps) {
  __shared__ float xs[kRows1 * kLanes];
  const int r0 = blockIdx.x * kRows1;
  const int n_rows = min(kRows1, rows - r0);
  for (int i = threadIdx.x; i < n_rows * kLanes; i += kThreads) {
    xs[i] = x[static_cast<size_t>(r0) * kLanes + i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * kLanes; e += kThreads) {
    const int rr = e / kLanes;
    const int j0 = idx[static_cast<size_t>(r0) * kLanes + e];
    const float* row = xs + rr * kLanes;
    float acc = 0.f;
    for (int i = 0; i < t_reps; ++i) {
      acc = __fadd_rn(acc, row[floor_mod(j0 + i, kLanes)]);
    }
    out[static_cast<size_t>(r0) * kLanes + e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_axis0_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ out, int rows, int t_reps) {
  extern __shared__ float xc[];  // [rows][kCols0]
  const int l0 = blockIdx.x * kCols0;
  for (int i = threadIdx.x; i < rows * kCols0; i += kThreads) {
    const int r = i / kCols0, c = i - r * kCols0;
    xc[i] = x[static_cast<size_t>(r) * kLanes + l0 + c];
  }
  __syncthreads();
  const int band = (rows + kBands0 - 1) / kBands0;
  const int r_begin = blockIdx.y * band;
  const int r_end = min(rows, r_begin + band);
  for (int e = r_begin * kCols0 + threadIdx.x; e < r_end * kCols0; e += kThreads) {
    const int r = e / kCols0, c = e - r * kCols0;
    const size_t o = static_cast<size_t>(r) * kLanes + l0 + c;
    const int j0 = idx[o];
    float acc = 0.f;
    for (int i = 0; i < t_reps; ++i) {
      acc = __fadd_rn(acc, xc[floor_mod(j0 + i, rows) * kCols0 + c]);
    }
    out[o] = acc;
  }
}

}  // namespace

// Launch P3 on `stream` over x, idx (rows, 128). Returns cudaGetLastError()
// after the launch (0 on success); cudaErrorInvalidValue for shapes it does
// not take (axis not 0 or 1, an empty grid, a column group above the
// card's shared memory per block).
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
    gather_axis1_kernel<<<(rows + kRows1 - 1) / kRows1, kThreads, 0, s>>>(
        xp, ip, op, rows, t_reps);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(rows) * kCols0 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_axis0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_axis0_kernel<<<dim3(kLanes / kCols0, kBands0), kThreads, smem, s>>>(
      xp, ip, op, rows, t_reps);
  return static_cast<int>(cudaGetLastError());
}
