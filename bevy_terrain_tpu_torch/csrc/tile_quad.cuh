// What the tile kernels (mesh_fused.cu, attach_sample.cu, fetch_resample.cu)
// share: the block-quad layout and fetch, the 33x33 half-grid tents, the
// 1-2-1 smoothing tap and the 3x3 vertex window.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int GV = 17;                // vertices per tile axis (grid_size 16)
constexpr int K = 33;                 // half-grid points per axis
constexpr int P = 64;                 // patch extent in texels
constexpr int QUAD_WORDS = 32 * 128;  // one (32, 128) int32 quad
constexpr int NVERT = GV * GV;        // 289 vertices per tile
constexpr int NTHREADS = 320;         // 10 full warps; threads >= 289 only help load
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_CH = 4;             // packed channels per int32 word

__device__ __forceinline__ float tent(float p, float r) {
  return fmaxf(0.0f, 1.0f - fabsf(p - r));
}

// natural half-grid index of window tap b of vertex i (pallas_kernels.py
// ysel / x-tent rows: 0 for i == 0, else 2i - 2 + b)
__device__ __forceinline__ int tap(int i, int b) { return i == 0 ? 0 : 2 * i - 2 + b; }

// channel c of a packed word (B = bits per channel, channel c in bits
// [cB, (c+1)B)); bits 0 is the raw signed word
__device__ __forceinline__ float unpack(unsigned word, int c, int bits) {
  if (bits == 0) return (float)(int)word;
  return (float)((word >> (bits * c)) & ((1u << bits) - 1u));
}

// The two non-zero taps of half-grid point (k, l) of a tile: texel rows
// r0, r0 + 1 and columns c0, c0 + 1 of the patch, with their tent weights
// (positions clip(p0 + k * dp, 0, 63)).
struct Taps {
  int r0, c0;
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Taps halfgrid_taps(float p0x, float p0y, float dp, int k, int l) {
  const float py = fminf(fmaxf(p0y + (float)k * dp, 0.0f), (float)(P - 1));
  const float px = fminf(fmaxf(p0x + (float)l * dp, 0.0f), (float)(P - 1));
  Taps t;
  t.r0 = min((int)floorf(py), P - 2);
  t.c0 = min((int)floorf(px), P - 2);
  t.wy0 = tent(py, (float)t.r0);
  t.wy1 = tent(py, (float)(t.r0 + 1));
  t.wx0 = tent(px, (float)t.c0);
  t.wx1 = tent(px, (float)(t.c0 + 1));
  return t;
}

// quad word v (of QUAD_WORDS / 4 int4 loads) -> patch row and column of its
// first texel: quad rows hold patch rows 0..31 in columns 0:64 and patch
// rows 32..63 in columns 64:128
__device__ __forceinline__ void quad_to_patch(int v, int& pr, int& pc) {
  const int r = v >> 5;        // quad row
  const int c = (v & 31) * 4;  // quad column
  pr = r + (c >= P ? 32 : 0);
  pc = c & (P - 1);
}

// Fetch one quad (QUAD_WORDS int32, 16-byte loads) into `patch` in natural
// texel order, as floats. Returns this thread's share of the exact integer
// texel sum.
__device__ __forceinline__ long long load_patch(const int* __restrict__ quad,
                                                float (*patch)[P]) {
  const int4* src = reinterpret_cast<const int4*>(quad);
  long long acc = 0;
  for (int v = threadIdx.x; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = __ldg(src + v);
    int pr, pc;
    quad_to_patch(v, pr, pc);
    patch[pr][pc + 0] = (float)w.x;
    patch[pr][pc + 1] = (float)w.y;
    patch[pr][pc + 2] = (float)w.z;
    patch[pr][pc + 3] = (float)w.w;
    acc += (long long)w.x + w.y + w.z + w.w;
  }
  return acc;
}

// The patch mean from the threads' shares of the texel sum (load_patch): an
// exact integer sum, divided once. Every thread of the block calls it and
// gets the mean; it ends with a barrier, after which the patch is visible
// to all threads. warp_sum (NWARPS) and s_mean are shared scratch.
__device__ __forceinline__ float block_mean(long long acc, long long* warp_sum,
                                            float* s_mean) {
  const int tid = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < NWARPS; ++w) total += warp_sum[w];
    *s_mean = (float)((double)total / (double)(P * P));
  }
  __syncthreads();
  return *s_mean;
}

// Half-grid point of the mean-centred patch through its two-by-two taps:
// Wy (patch - mean) Wx^T at one (k, l), before the mean is added back.
__device__ __forceinline__ float centred_bilinear(float (*patch)[P], float mean,
                                                  const Taps& tw) {
  const int r0 = tw.r0, c0 = tw.c0;
  const float col0 = tw.wy0 * (patch[r0][c0] - mean) + tw.wy1 * (patch[r0 + 1][c0] - mean);
  const float col1 =
      tw.wy0 * (patch[r0][c0 + 1] - mean) + tw.wy1 * (patch[r0 + 1][c0 + 1] - mean);
  return col0 * tw.wx0 + col1 * tw.wx1;
}

// One tap of the 1-2-1 smoothing (the caller duplicates boundary rows by
// clamping the neighbours' indices).
__device__ __forceinline__ float smooth3(float lo, float mid, float hi) {
  return 0.25f * lo + 0.5f * mid + 0.25f * hi;
}

}  // namespace
