// P1: the chunk-stream probe on Hopper.
//
// Replaces tools/spike_dma.py:53 run (kernel body _kernel, :14): per
// (view, tile), stream the tile's run of (8, c) f32 chunks of x (B, 8, L)
// from device memory, sum them, and write acc + iota over the (th, tw)
// tile of out (B, n_tiles * th, tw). The TPU kernel's make_async_copy pair
// (two VMEM slots, a DMA semaphore each) becomes cp.async into two
// shared-memory slots: chunk ci + 1 is in flight while chunk ci is summed.
// This is the stream K1's chunk loop reads, so the probe measures the floor
// of that loop's memory side.
//
// What bounds it: bytes. Each live chunk is read once (8 * c * 4 bytes),
// each output written once; the adds are one per element read.
//
// Bits: thread t keeps a partial sum over the chunk elements t, t + 256,
// t + 512, ... (flat index row * c + col) of every chunk in order; a
// shared-memory tree (s[t] += s[t + k] for k = 128, 64, ..., 1) reduces the
// 256 partials. The plain version (probes/chunk_stream.py) adds in the same
// order, so the two agree bit for bit; the TPU kernel's order (a sum per
// chunk, then a running total) differs within fp32 round-off.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One block per (view, tile). buf holds two chunk slots of 8 * c floats.
__global__ void __launch_bounds__(kThreads)
    chunk_stream_kernel(const float* __restrict__ x,
                        const int* __restrict__ starts,
                        const int* __restrict__ n_chunks,
                        float* __restrict__ out, int l, int n_tiles, int th,
                        int tw, int c) {
  extern __shared__ __align__(16) float buf[];  // [2][8 * c], then [kThreads]
  float* red = buf + 2 * 8 * c;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int per_row = c / 4;  // 16-byte pieces per chunk row
  const int n_pieces = 8 * per_row;

  // Clamp the run to the array so a malformed start/count cannot read past it.
  const int nch_total = l / c;
  int base = starts[b * n_tiles + tile];
  int nch = n_chunks[b * n_tiles + tile];
  base = min(max(base, 0), nch_total);
  nch = min(max(nch, 0), nch_total - base);

  const float* xb = x + static_cast<size_t>(b) * 8 * l;
  auto stage = [&](int slot, int ci) {
    const size_t col0 = static_cast<size_t>(base + ci) * c;
    for (int i = t; i < n_pieces; i += kThreads) {
      const int row = i / per_row, q = i - row * per_row;
      cp_async16(buf + slot * 8 * c + i * 4, xb + row * static_cast<size_t>(l) + col0 + q * 4);
    }
    cp_async_commit();
  };

  float partial = 0.f;
  if (nch > 0) stage(0, 0);
  for (int ci = 0; ci < nch; ++ci) {
    const int slot = ci & 1;
    if (ci + 1 < nch) {
      stage(slot ^ 1, ci + 1);
      cp_async_wait<1>();  // chunk ci has landed; ci + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ch = buf + slot * 8 * c;
    for (int i = t; i < 8 * c; i += kThreads) partial = __fadd_rn(partial, ch[i]);
    __syncthreads();  // every thread is done with this slot before it refills
  }

  red[t] = partial;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) red[t] = __fadd_rn(red[t], red[t + k]);
    __syncthreads();
  }
  const float acc = red[0];
  float* ob = out + (static_cast<size_t>(b) * n_tiles + tile) * th * tw;
  for (int p = t; p < th * tw; p += kThreads) {
    ob[p] = __fadd_rn(acc, static_cast<float>(p));
  }
}

}  // namespace

// Launch P1 on `stream`. Returns cudaGetLastError() after the launch (0 on
// success); cudaErrorInvalidValue for shapes it does not take (c not a
// multiple of 32, L not a multiple of 4, two chunk slots above 48 KB of
// shared memory, an empty grid).
extern "C" int chunk_stream_launch(const void* x, const void* starts,
                                   const void* n_chunks, void* out, int bsz,
                                   int l, int n_tiles, int th, int tw, int c,
                                   void* stream) {
  const size_t smem = (2 * 8 * static_cast<size_t>(c) + kThreads) * sizeof(float);
  if (bsz <= 0 || n_tiles <= 0 || th <= 0 || tw <= 0 || c <= 0 || c % 32 ||
      l % 4 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chunk_stream_kernel<<<dim3(n_tiles, bsz), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(starts),
      static_cast<const int*>(n_chunks), static_cast<float*>(out), l, n_tiles,
      th, tw, c);
  return static_cast<int>(cudaGetLastError());
}
