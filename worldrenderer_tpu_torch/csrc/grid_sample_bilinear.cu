// S1: the bake's bilinear texel sampler on Hopper.
//
// Replaces no TPU kernel: the JAX package samples with plain XLA
// (worldrenderer_tpu/ops/grid_sample.py:74 grid_sample_parts, no
// pallas_call), which builds a zero-padded quad table (every channel's four
// bilinear taps in one row), gathers one row per (view, texel) and blends
// the taps after the gather. Its plain PyTorch version
// (ops/grid_sample.py grid_sample_parts_plain) does the same, and on the
// card it writes and reads back a tap tensor of 16 * C bytes per texel.
// S1 computes the same function with no table and no tap tensor: per
// (view, texel) it reads the NDC pair, reads the four taps of every channel
// straight from the channels-last view maps and writes the blend.
//
// What bounds it: bytes. Per (view, texel) it reads 8 bytes of NDC and
// writes 4 * C bytes; the maps of one view (a 768^2 bake view with 5
// geometry channels: 11.8 MB) fit the 50 MB L2, and texels that fall on
// one view pixel share its taps. So a block covers a 32 x 8 tile of the
// atlas in one view, the view the slowest grid axis: neighbouring threads
// read neighbouring view pixels, and one view's maps stay in L2 while its
// texels run. A warp is one row of the tile, so its NDC loads are
// coalesced; it stages its 32 texels' outputs in shared memory and writes
// them as one contiguous run. A thread waits on its NDC read and then on
// its tap reads, so it issues the 16 tap reads of four channels before it
// blends them: one wait per four channels, not per channel (on an H100,
// 3.47-3.55 against 6.14 ms for the tex4k bake's two calls).
//
// Bits: each channel equals the plain version's bit for bit. The
// coordinates, floor, int32 saturation (NaN -> 0), the int32 wrap of
// x0 + 1, the four in-bounds flags and the weights (+0 where a tap's flag
// is off) follow the plain version's expressions in its rounding order,
// spelled with __fadd_rn / __fsub_rn / __fmul_rn (the build also passes
// -fmad=false). A tap is what the plain quad row holds: padded-image pixel
// (clamp(y0 + 1, 0, H) + dy, clamp(x0 + 1, 0, W) + dx), 0 in the one-pixel
// zero border. Every tap is multiplied by its weight, also a weight of 0,
// so NaN and inf taps, far-out-of-range coordinates and -0 come out as
// the plain version gives them; the sum is ((t00 w00 + t01 w01) + t10 w10)
// + t11 w11. 'u8' parts are read as the bytes of their 255-quantized copy
// and turned into values through the plain version's 256-entry table.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstring>

namespace {

constexpr int kTileW = 32;  // a warp: one row of the tile
constexpr int kTileH = 8;
constexpr int kMaxParts = 8;
// Outputs staged per warp: 32 texels x at most kStageChannels channels.
constexpr int kStageChannels = 16;

struct Part {
  const void* data;  // (N, H, W, C) float32, or uint8 for a 'u8' part
  int channels;
  int u8;
};

struct SampleArgs {
  const float* grid;  // (N, Hg, Wg, 2) NDC, (x, y)
  float* out;         // (N, Hg, Wg, out_channels)
  int n, h, w, hg, wg;
  int out_channels;  // the output row's width
  int out_offset;    // this launch's first channel in the row
  int channels;      // this launch's channels, summed over its parts
  int n_parts;
  int any_u8;
  float half_w, half_h;  // w * 0.5, h * 0.5
  Part parts[kMaxParts];
  float byte_values[256];  // byte -> value of a 'u8' part
};

// The plain version's to_int32_sat(floor(v)): NaN -> 0, saturated at the
// int32 range.
__device__ __forceinline__ int floor_to_int32_sat(float v) {
  const float f = floorf(v);
  if (f != f) return 0;
  if (f >= 2147483648.f) return INT_MAX;
  if (f <= -2147483648.f) return INT_MIN;
  return static_cast<int>(f);
}

// v + 1 in int32 with the wrap of a PyTorch int32 add.
__device__ __forceinline__ int add1_wrap(int v) {
  return static_cast<int>(static_cast<unsigned>(v) + 1u);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A part's samples at one texel into dst[0 .. channels): the four taps of
// up to four channels are loaded together, then blended.
template <bool kU8>
__device__ __forceinline__ void blend_part(const Part& part, long long base,
                                           int row_step, unsigned ok,
                                           const float (&wt)[4],
                                           const float* byte_values,
                                           float* dst) {
  const int c_ch = part.channels;
  const long long first = base * c_ch;
  const int step[4] = {0, c_ch, row_step * c_ch, (row_step + 1) * c_ch};
  for (int c0 = 0; c0 < c_ch; c0 += 4) {
    float tap[4][4];  // [channel][tap]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tap[k][q] = 0.f;
        if (c0 + k < c_ch && (ok >> q & 1u)) {
          const long long i = first + step[q] + c0 + k;
          tap[k][q] =
              kU8 ? byte_values[__ldg(static_cast<const unsigned char*>(part.data) + i)]
                  : __ldg(static_cast<const float*>(part.data) + i);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k < c_ch) {
        dst[c0 + k] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(tap[k][0], wt[0]), __fmul_rn(tap[k][1], wt[1])),
                      __fmul_rn(tap[k][2], wt[2])),
            __fmul_rn(tap[k][3], wt[3]));
      }
    }
  }
}

template <bool kStage>
__global__ void __launch_bounds__(kTileW * kTileH)
    sample_kernel(const SampleArgs a) {
  __shared__ float byte_values[256];
  extern __shared__ float stage[];  // [kTileH][kTileW * channels]
  if (a.any_u8) {
    for (int i = threadIdx.y * kTileW + threadIdx.x; i < 256;
         i += kTileW * kTileH) {
      byte_values[i] = a.byte_values[i];
    }
    __syncthreads();
  }
  const int lane = threadIdx.x;
  const int tiles_y = (a.hg + kTileH - 1) / kTileH;
  const int gx = blockIdx.x * kTileW + lane;
  const int n_valid = min(kTileW, a.wg - static_cast<int>(blockIdx.x) * kTileW);
  float* my_stage = stage + threadIdx.y * kTileW * a.channels;

  for (int v = blockIdx.z; v < a.n; v += gridDim.z) {
    for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
      const int gy = ty * kTileH + threadIdx.y;
      if (gy >= a.hg) continue;  // a whole warp
      const size_t row = (static_cast<size_t>(v) * a.hg + gy) * a.wg;
      if (gx < a.wg) {
        const size_t t = row + gx;
        const float ndc_x = a.grid[2 * t], ndc_y = a.grid[2 * t + 1];
        const float x = __fsub_rn(__fmul_rn(__fadd_rn(ndc_x, 1.f), a.half_w), 0.5f);
        const float y = __fsub_rn(__fmul_rn(__fadd_rn(ndc_y, 1.f), a.half_h), 0.5f);
        const int x0 = floor_to_int32_sat(x), y0 = floor_to_int32_sat(y);
        const int x1 = add1_wrap(x0), y1 = add1_wrap(y0);
        const float fx = __fsub_rn(x, __int2float_rn(x0));
        const float fy = __fsub_rn(y, __int2float_rn(y0));
        const bool in_x0 = x0 >= 0 && x0 < a.w, in_x1 = x1 >= 0 && x1 < a.w;
        const bool in_y0 = y0 >= 0 && y0 < a.h, in_y1 = y1 >= 0 && y1 < a.h;
        const float omfx = __fsub_rn(1.f, fx), omfy = __fsub_rn(1.f, fy);
        const float wt[4] = {in_x0 && in_y0 ? __fmul_rn(omfx, omfy) : 0.f,
                             in_x1 && in_y0 ? __fmul_rn(fx, omfy) : 0.f,
                             in_x0 && in_y1 ? __fmul_rn(omfx, fy) : 0.f,
                             in_x1 && in_y1 ? __fmul_rn(fx, fy) : 0.f};

        // The quad row's taps: padded pixel (ry + dy, cx + dx), image pixel
        // (ry + dy - 1, cx + dx - 1), 0 outside the image; bit q of ok says
        // tap q (00, 01, 10, 11) lies inside.
        const int ry = clamp_int(y1, 0, a.h), cx = clamp_int(x1, 0, a.w);
        const bool ok_y0 = ry >= 1, ok_y1 = ry < a.h;
        const bool ok_x0 = cx >= 1, ok_x1 = cx < a.w;
        const unsigned ok = (ok_y0 && ok_x0 ? 1u : 0u) | (ok_y0 && ok_x1 ? 2u : 0u) |
                            (ok_y1 && ok_x0 ? 4u : 0u) | (ok_y1 && ok_x1 ? 8u : 0u);
        const long long base =
            (static_cast<long long>(v) * a.h + (ry - 1)) * a.w + (cx - 1);

        float* dst = kStage ? my_stage + lane * a.channels
                            : a.out + t * a.out_channels + a.out_offset;
        for (int p = 0; p < a.n_parts; ++p) {
          const Part part = a.parts[p];
          if (part.u8) {
            blend_part<true>(part, base, a.w, ok, wt, byte_values, dst);
          } else {
            blend_part<false>(part, base, a.w, ok, wt, byte_values, dst);
          }
          dst += part.channels;
        }
      }
      if (kStage) {
        // The warp's texels, one contiguous run of the output row when
        // this launch writes whole rows.
        __syncwarp();
        const int run = n_valid * a.channels;
        const size_t first = row + static_cast<size_t>(blockIdx.x) * kTileW;
        if (a.channels == a.out_channels) {
          float* dst = a.out + first * a.out_channels;
          for (int i = lane; i < run; i += kTileW) dst[i] = my_stage[i];
        } else {
          for (int i = lane; i < run; i += kTileW) {
            const int j = i / a.channels, c = i - j * a.channels;
            a.out[(first + j) * a.out_channels + a.out_offset + c] = my_stage[i];
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

// Launch S1 on `stream` for n_parts (1..8) parts: data[p] is part p's
// (n, h, w, channels[p]) map, float32, or uint8 where u8[p] is nonzero (the
// 255-quantized copy; byte_values, 256 floats on the host, maps a byte to
// its value). grid (n, hg, wg, 2) float32; out (n, hg, wg, out_channels)
// float32, of which this launch writes the channels from out_offset on,
// the parts' channels in order. Returns cudaGetLastError() after the launch
// (0 on success); cudaErrorInvalidValue for arguments it does not take.
extern "C" int grid_sample_bilinear_launch(
    const void* grid, void* out, const void* const* data, const int* channels,
    const int* u8, int n_parts, int n, int h, int w, int hg, int wg,
    int out_channels, int out_offset, const float* byte_values, void* stream) {
  if (n_parts <= 0 || n_parts > kMaxParts || n <= 0 || h < 0 || w < 0 ||
      hg <= 0 || wg <= 0 || out_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SampleArgs a{};
  a.grid = static_cast<const float*>(grid);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.h = h;
  a.w = w;
  a.hg = hg;
  a.wg = wg;
  a.out_channels = out_channels;
  a.out_offset = out_offset;
  a.n_parts = n_parts;
  a.half_w = static_cast<float>(w * 0.5);
  a.half_h = static_cast<float>(h * 0.5);
  for (int p = 0; p < n_parts; ++p) {
    if (channels[p] <= 0 ||
        static_cast<long long>(w + 1) * channels[p] > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.parts[p] = Part{data[p], channels[p], u8[p] != 0};
    a.channels += channels[p];
    a.any_u8 |= u8[p] != 0;
  }
  if (out_offset + a.channels > out_channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.any_u8) std::memcpy(a.byte_values, byte_values, sizeof(a.byte_values));

  const int tiles_x = (wg + kTileW - 1) / kTileW;
  const int tiles_y = (hg + kTileH - 1) / kTileH;
  const dim3 grid_dim(tiles_x, std::min(tiles_y, 65535), std::min(n, 65535));
  const dim3 block(kTileW, kTileH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.channels <= kStageChannels) {
    const size_t smem = sizeof(float) * kTileH * kTileW * a.channels;
    sample_kernel<true><<<grid_dim, block, smem, s>>>(a);
  } else {
    sample_kernel<false><<<grid_dim, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
