// P2: the record-table transpose probe on Hopper.
//
// Replaces tools/probe_transpose.py:89 b_pallas (kernel body _tr_kernel,
// :76): x (V, R, N) f32 -> y (V*N, R) f32, y[v*N + n, r] = x[v, r, n]. The
// TPU kernel moves (R, B) blocks through an identity matmul at HIGHEST
// precision, an exact transpose; here a block moves an (R, kTileN) tile
// through shared memory.
//
// What bounds it: bytes, every input read once and every output written
// once. Reads are coalesced along n (one row of the tile per pass); the
// block's output is one contiguous run of kTileN * R floats, written in
// order. The tile's rows are padded to kTileN + 1 words, so the column
// reads of the write pass (stride kTileN + 1) fall in distinct banks.
// R need not be a multiple of 32: the write pass walks the flat output
// run, and the ragged last tile of n is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr int kMaxR = 64;

__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const float* __restrict__ x, float* __restrict__ y, int r,
                     long long n) {
  extern __shared__ float tile[];  // [r][kTileN + 1]
  const int v = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * kTileN;
  const int w = static_cast<int>(min(static_cast<long long>(kTileN), n - n0));
  const float* xv = x + static_cast<size_t>(v) * r * n;
  for (int i = threadIdx.x; i < r * kTileN; i += kThreads) {
    const int row = i / kTileN, j = i - row * kTileN;
    if (j < w) tile[row * (kTileN + 1) + j] = xv[row * n + n0 + j];
  }
  __syncthreads();
  float* yv = y + (static_cast<size_t>(v) * n + n0) * r;
  for (int o = threadIdx.x; o < w * r; o += kThreads) {
    const int j = o / r, row = o - j * r;
    yv[o] = tile[row * (kTileN + 1) + j];
  }
}

}  // namespace

// Launch P2 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for shapes it does not take (R outside
// 1..64, an empty grid, more than 65535 views).
extern "C" int transpose_launch(const void* x, void* y, int v, int r,
                                long long n, void* stream) {
  if (v <= 0 || v > 65535 || r <= 0 || r > kMaxR || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(r) * (kTileN + 1) * sizeof(float);
  const long long tiles = (n + kTileN - 1) / kTileN;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<<<dim3(static_cast<unsigned>(tiles), v), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), r, n);
  return static_cast<int>(cudaGetLastError());
}
