// Attachment samplers for Hopper (sm_90a): one attachment sampled at given
// vertex uvs, the fragment stage's attachment fetch for materials.
//
// Replaces the JAX package's TPU kernels ops/pallas_kernels.py::
// attach_sample_fused (K5a: one raw channel per int32 word) and
// attach_sample_fused_packed (K5b: C channels of B bits packed into each
// word, Rgba8 = 4 x 8, Rg16 = 2 x 16), body _attach_step_compute. Per tile:
// the 16 KB quad of the tile's patch, per channel the unpack, the
// mean-centred tent resample to the 33x33 half-grid (the mean an exact
// integer sum), then the 3x3 window at the given uvs, x valid. As in the
// mesh kernel (mesh_fused.cu), the TPU kernel's VMEM ring and MXU
// contractions do not carry over: a block per tile reads its quad through
// L2 with 16-byte loads (a frame touches a few hundred unique quads for a
// few thousand tiles), and a tent has two taps, so each half-grid point is
// a 2x2 bilinear. The kernel is bound by the bytes it moves: the unique
// quads once, the per-vertex uvs in, C values per vertex out.
//
// Output: (n_tiles, C, 17, 17) f32 raw texel values (the caller
// normalises); tiles at index >= tile_count (read from device memory) are
// zeros, as the TPU kernel zeroes its dead steps. Built without FMA
// contraction, like the mesh kernel.

#include <cuda_runtime.h>

#include "tile_quad.cuh"

namespace {

// channel c of a word as an exact integer (bits 0: the raw signed word)
__device__ __forceinline__ long long field(int word, int c, int bits) {
  if (bits == 0) return word;
  return ((unsigned)word >> (bits * c)) & ((1u << bits) - 1u);
}

__global__ void __launch_bounds__(NTHREADS)
attach_sample_kernel(const int* __restrict__ blocks, long long n_blocks,
                     const int* __restrict__ ids,
                     const float* __restrict__ geom,        // (n, 8)
                     const float* __restrict__ uvs,         // (n, 2, 17, 17)
                     const int* __restrict__ tile_count,    // (1,)
                     int channels, int bits, float* __restrict__ out) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int out_per_tile = channels * NVERT;
  float* o = out + (size_t)t * out_per_tile;
  if (t >= __ldg(tile_count)) {
    for (int e = tid; e < out_per_tile; e += NTHREADS) o[e] = 0.0f;
    return;
  }

  __shared__ unsigned words[P][P];     // the patch's packed words
  __shared__ float A[MAX_CH][K][K];    // half-grids, one per channel
  __shared__ long long warp_sum[NWARPS][MAX_CH];
  __shared__ float mean[MAX_CH];

  // ---- 1. fetch the quad into natural patch order; exact channel sums ----
  long long q = ids[t];
  q = q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
  const int4* src = reinterpret_cast<const int4*>(blocks + q * QUAD_WORDS);
  long long acc[MAX_CH] = {0, 0, 0, 0};
  for (int v = tid; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = __ldg(src + v);
    int pr, pc;
    quad_to_patch(v, pr, pc);
    words[pr][pc + 0] = (unsigned)w.x;
    words[pr][pc + 1] = (unsigned)w.y;
    words[pr][pc + 2] = (unsigned)w.z;
    words[pr][pc + 3] = (unsigned)w.w;
    for (int ch = 0; ch < channels; ++ch)
      acc[ch] += field(w.x, ch, bits) + field(w.y, ch, bits) + field(w.z, ch, bits) +
                 field(w.w, ch, bits);
  }
  for (int ch = 0; ch < channels; ++ch) {
    long long a = acc[ch];
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5][ch] = a;
  }
  __syncthreads();
  if (tid < channels) {
    long long total = 0;
    for (int w = 0; w < NWARPS; ++w) total += warp_sum[w][tid];
    mean[tid] = (float)((double)total / (double)(P * P));
  }
  __syncthreads();

  // ---- 2. per channel: A = Wy (T - m) Wx^T + m at the half-grid positions
  // clip(p0 + k * dp, 0, 63) ----
  const float* g = geom + (size_t)t * 8;
  const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3];
  for (int e = tid; e < channels * K * K; e += NTHREADS) {
    const int ch = e / (K * K), kl = e % (K * K);
    const int k = kl / K, l = kl % K;
    const Taps tw = halfgrid_taps(p0x, p0y, dp, k, l);
    const int r0 = tw.r0, c0 = tw.c0;
    const float m = mean[ch];
    const float t00 = unpack(words[r0][c0], ch, bits) - m;
    const float t10 = unpack(words[r0 + 1][c0], ch, bits) - m;
    const float t01 = unpack(words[r0][c0 + 1], ch, bits) - m;
    const float t11 = unpack(words[r0 + 1][c0 + 1], ch, bits) - m;
    const float col0 = tw.wy0 * t00 + tw.wy1 * t10;
    const float col1 = tw.wy0 * t01 + tw.wy1 * t11;
    A[ch][k][l] = (col0 * tw.wx0 + col1 * tw.wx1) + m;
  }
  __syncthreads();

  // ---- 3. per vertex (i = row / v, j = column / u): the 3x3 tent window
  // at the given uv ----
  if (tid >= NVERT) return;
  const int i = tid / GV, j = tid % GV;
  const float* uv = uvs + (size_t)t * 2 * NVERT;
  const float lxw = uv[tid] * (2.0f * (GV - 1.0f)) - (float)max(2 * j - 2, 0);
  const float lyw = uv[NVERT + tid] * (2.0f * (GV - 1.0f)) - (float)max(2 * i - 2, 0);
  float wyb[3], wxa[3];
  for (int b = 0; b < 3; ++b) {
    wyb[b] = tent(lyw, (float)b);
    wxa[b] = tent(lxw, (float)b);
  }
  for (int ch = 0; ch < channels; ++ch) {
    float h = 0.0f;
    for (int b = 0; b < 3; ++b) {
      const int r = tap(i, b);
      for (int a = 0; a < 3; ++a) h = h + wyb[b] * wxa[a] * A[ch][r][tap(j, a)];
    }
    o[ch * NVERT + tid] = h * valid;
  }
}

}  // namespace

// K5a (bits 0, one channel) and K5b. Launches on the caller's stream;
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int attach_sample_launch(const void* blocks, long long n_blocks, const void* ids,
                                    const void* geom, const void* uvs,
                                    const void* tile_count, int channels, int bits,
                                    void* out, int n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  if (channels < 1 || channels > MAX_CH || (bits != 0 && bits != 8 && bits != 16) ||
      (bits == 0 && channels != 1) || channels * bits > 32)
    return (int)cudaErrorInvalidValue;
  attach_sample_kernel<<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom, (const float*)uvs,
      (const int*)tile_count, channels, bits, (float*)out);
  return (int)cudaGetLastError();
}
