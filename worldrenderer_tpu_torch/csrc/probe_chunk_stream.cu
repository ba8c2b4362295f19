// P1: the chunk-stream probe on Hopper.
//
// Replaces tools/spike_dma.py:53 run (kernel body _kernel, :14): per
// (view, tile), stream the tile's run of (8, c) f32 chunks of x (B, 8, L)
// from device memory, sum them, and write acc + iota over the (th, tw)
// tile of out (B, n_tiles * th, tw). This is the stream K1's chunk loop
// reads, so the probe measures the floor of that loop's memory side.
//
// What bounds it: bytes. Each live chunk is read once (8 * c * 4 bytes),
// each output written once; the adds are one per element read. Its runs
// are short (K1's on the headline: 760 live chunks over 768 tiles, about
// one a tile), so the design is for a block that reads one or two chunks
// and writes twice as many bytes:
//   * a chunk is 2c sixteen-byte pieces; thread t of 256 loads pieces t,
//     t + 256, ... of every chunk of a group of kGroup chunks straight into
//     registers, all before the first add (no shared-memory staging, no
//     barrier per chunk, no division: a piece's row and column are a shift
//     and a mask of c / 4); a longer run takes its groups in turn;
//   * the 256 partials meet in a warp-shuffle tree, then one shared-memory
//     step across the 8 warps;
//   * the tile's outputs go out as sixteen-byte stores where th * tw is a
//     multiple of 4.
//
// Bits: thread t sums, chunk by chunk in run order, its pieces t, t + 256,
// ... and each piece's four floats in order, from +0. Then each warp adds
// lane l + k into lane l for k = 16, 8, 4, 2, 1 (shfl_down), and lane 0
// of warp 0 does the same over the 8 warp sums for k = 4, 2, 1. The plain
// version (probes/chunk_stream.py) adds in the same order, so the two
// agree bit for bit; the TPU kernel's order (a sum per chunk, then a
// running total) differs within fp32 round-off.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // chunks whose pieces a thread holds at once

// P: pieces a thread loads per chunk, 1 for c <= 128 and 2 for c = 256.
template <int P>
__global__ void __launch_bounds__(kThreads)
    chunk_stream_kernel(const float* __restrict__ x,
                        const int* __restrict__ starts,
                        const int* __restrict__ n_chunks,
                        float* __restrict__ out, int l, int n_tiles, int th,
                        int tw, int c_log2) {
  __shared__ float warp_sums[kWarps];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int c = 1 << c_log2;
  const int per_row_log2 = c_log2 - 2;  // sixteen-byte pieces per chunk row
  const int n_pieces = 8 << per_row_log2;

  // Clamp the run to the array so a malformed start/count cannot read past it.
  const int nch_total = l >> c_log2;
  int base = starts[b * n_tiles + tile];
  int nch = n_chunks[b * n_tiles + tile];
  base = min(max(base, 0), nch_total);
  nch = min(max(nch, 0), nch_total - base);

  // This thread's pieces of chunk 0 of the run, as offsets into the view.
  const float* xb = x + static_cast<size_t>(b) * 8 * l;
  size_t off[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = t + q * kThreads;
    const int row = i >> per_row_log2, col = (i & ((1 << per_row_log2) - 1)) * 4;
    off[q] = static_cast<size_t>(row) * l + (static_cast<size_t>(base) << c_log2) + col;
  }

  float partial = 0.f;
  for (int g0 = 0; g0 < nch; g0 += kGroup) {
    float4 v[kGroup][P];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (g0 + g < nch && t + q * kThreads < n_pieces) {
          v[g][q] = __ldg(reinterpret_cast<const float4*>(
              xb + off[q] + (static_cast<size_t>(g0 + g) << c_log2)));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (g0 + g < nch && t + q * kThreads < n_pieces) {
          partial = __fadd_rn(partial, v[g][q].x);
          partial = __fadd_rn(partial, v[g][q].y);
          partial = __fadd_rn(partial, v[g][q].z);
          partial = __fadd_rn(partial, v[g][q].w);
        }
      }
    }
  }

#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    partial = __fadd_rn(partial, __shfl_down_sync(0xffffffffu, partial, k));
  }
  if ((t & 31) == 0) warp_sums[t >> 5] = partial;
  __syncthreads();
  float acc = t < kWarps ? warp_sums[t] : 0.f;
  if (t < 32) {
#pragma unroll
    for (int k = kWarps / 2; k > 0; k >>= 1) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, k));
    }
  }
  if (t == 0) warp_sums[0] = acc;
  __syncthreads();
  acc = warp_sums[0];

  const int p_tile = th * tw;
  float* ob = out + (static_cast<size_t>(b) * n_tiles + tile) * p_tile;
  if ((p_tile & 3) == 0) {
    for (int p = 4 * t; p < p_tile; p += 4 * kThreads) {
      const float4 o = {__fadd_rn(acc, static_cast<float>(p)),
                        __fadd_rn(acc, static_cast<float>(p + 1)),
                        __fadd_rn(acc, static_cast<float>(p + 2)),
                        __fadd_rn(acc, static_cast<float>(p + 3))};
      reinterpret_cast<float4*>(ob)[p >> 2] = o;
    }
  } else {
    for (int p = t; p < p_tile; p += kThreads) {
      ob[p] = __fadd_rn(acc, static_cast<float>(p));
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Launch P1 on `stream`; x and out must be 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success); cudaErrorInvalidValue
// for shapes it does not take (c not a power of two from 32 to 256, L not a
// multiple of 4, an empty grid).
extern "C" int chunk_stream_launch(const void* x, const void* starts,
                                   const void* n_chunks, void* out, int bsz,
                                   int l, int n_tiles, int th, int tw, int c,
                                   void* stream) {
  int c_log2 = 0;
  while ((1 << c_log2) < c) ++c_log2;
  if (bsz <= 0 || n_tiles <= 0 || th <= 0 || tw <= 0 || c != (1 << c_log2) ||
      c < 32 || c > 256 || l % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_tiles, bsz);
  auto s = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<const int*>(starts);
  auto* np = static_cast<const int*>(n_chunks);
  auto* op = static_cast<float*>(out);
  if (c == 256) {
    chunk_stream_kernel<2><<<grid, kThreads, 0, s>>>(xp, sp, np, op, l, n_tiles,
                                                     th, tw, c_log2);
  } else {
    chunk_stream_kernel<1><<<grid, kThreads, 0, s>>>(xp, sp, np, op, l, n_tiles,
                                                     th, tw, c_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel of one block on `stream`: what a launch
// costs the host and the card, beside the probe's times.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
