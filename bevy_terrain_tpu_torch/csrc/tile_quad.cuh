// What the tile kernels (mesh_fused.cu, attach_sample.cu) share: the
// block-quad layout, the 33x33 half-grid tents and the 3x3 vertex window.
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

}  // namespace
