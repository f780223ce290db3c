// Attachment samplers for Hopper (sm_90a): one attachment sampled at given
// vertex uvs, the fragment stage's attachment fetch for materials.
//
// Replaces the JAX package's TPU kernels ops/pallas_kernels.py::
// attach_sample_fused (K5a: one raw channel per int32 word) and
// attach_sample_fused_packed (K5b: C channels of B bits packed into each
// word, Rgba8 = 4 x 8, Rg16 = 2 x 16), body _attach_step_compute. Per tile:
// the 16 KB quad of the tile's patch, per channel the unpack, the
// mean-centred tent resample to the 33x33 half-grid (the mean an exact
// integer sum), then the 3x3 window at the given uvs, x valid. A tent has
// two taps, so each half-grid point is a 2x2 bilinear (the TPU kernel's MXU
// contractions do not carry over).
//
// The kernel is bound by the bytes it moves: the unique quads once, the
// per-vertex uvs in, C values per vertex out. What keeps it off that bound
// is per-tile latency, so its design spends as little as it can per tile:
//
// * A block walks a run of consecutive tiles in the plan's order, which
//   sorts the tiles by quad id (a frame reads a few hundred unique quads
//   for a few thousand tiles): the live tiles are split evenly over a grid
//   of `waves` (a launch constant of ops/kernels.py) times the blocks the
//   card holds at once, so no block waits for a tail wave. It keeps the
//   quad it holds, raw in shared memory, and its exact channel means while
//   the ids repeat: the fetch and the integer sums run once per run of
//   equal ids, not once per tile, as the TPU kernel's ring of unique quads
//   kept them out of memory. Any order of ids is right; a sorted one is
//   fast.
// * The next tile's quad, when it differs, is copied with cp.async as soon
//   as the current tile's half-grids are done, behind its vertex phase.
// * One pass per half-grid point over all channels: the taps once, the four
//   words once, every channel from them (tile_quad.cuh halfgrid_channels).
// * Tiles at index >= tile_count (read from device memory) are zeros,
//   written with 16-byte stores and no fetch, as the TPU kernel zeroes its
//   dead steps.
//
// Output: (n_tiles, C, 17, 17) f32 raw texel values (the caller
// normalises). Built without FMA contraction, like the mesh kernel; the
// per-point arithmetic is the plain version's, so a block's run length
// changes no bit of the output.

#include <cuda_runtime.h>

#include "tile_quad.cuh"

namespace {

// four blocks of 320 threads per SM: registers capped to match (the shared
// memory allows six)
constexpr int SAMPLER_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(NTHREADS, SAMPLER_MIN_BLOCKS)
attach_sample_kernel(const int* __restrict__ blocks, long long n_blocks,
                     const int* __restrict__ ids,
                     const float* __restrict__ geom,        // (n, 8)
                     const float* __restrict__ uvs,         // (n, 2, 17, 17)
                     const int* __restrict__ tile_count,    // (1,)
                     int n_tiles, int channels, int bits, float* __restrict__ out) {
  const int out_per_tile = channels * NVERT;
  const TileRun run = tile_run(n_tiles, __ldg(tile_count));
  zero_fill(out + (size_t)run.d0 * out_per_tile, out + (size_t)run.d1 * out_per_tile);
  if (run.t0 == run.t1) return;

  __shared__ __align__(16) int quad[QUAD_WORDS];  // the held quad, raw
  __shared__ float A[MAX_CH][K][K];               // half-grids, one per channel
  __shared__ long long warp_sum[NWARPS][MAX_SUMS];
  __shared__ float mean[MAX_SUMS];

  long long q = quad_id(ids, run.t0, n_blocks);
  fetch_quad_async(quad, blocks + q * QUAD_WORDS);
  cp_async_wait();
  __syncthreads();
  bool fetched = true;  // the quad in shared memory is new: take its means
  for (int t = run.t0; t < run.t1; ++t) {
    const int tid = opaque((int)threadIdx.x);
    if (fetched) {
      long long acc[MAX_SUMS] = {0, 0, 0, 0, 0};
      quad_sums(quad, channels, bits, acc);
      block_means(acc, channels, warp_sum, mean);
      fetched = false;
    }

    // ---- 1. every channel's half-grid, A = Wy (T - m) Wx^T + m at the
    // positions clip(p0 + k * dp, 0, 63), from one read of each point's
    // words ----
    const float* g = geom + (size_t)t * 8;
    const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3];
    for (int e = tid; e < K * K; e += NTHREADS) {
      const int k = e / K, l = e % K;
      const Taps tw = halfgrid_taps(p0x, p0y, dp, k, l);
      halfgrid_channels(quad_corners(quad, tw), tw, channels, bits, false, mean, &A[0][k][l]);
    }
    __syncthreads();

    // the quad is free: start the next tile's, if it is another
    if (t + 1 < run.t1) {
      const long long next = quad_id(ids, t + 1, n_blocks);
      if (next != q) {
        q = next;
        fetch_quad_async(quad, blocks + q * QUAD_WORDS);
        fetched = true;
      }
    }

    // ---- 2. per vertex (i = row / v, j = column / u): the 3x3 tent window
    // at the given uv ----
    if (tid < NVERT) {
      const int i = tid / GV, j = tid % GV;
      const float* uv = uvs + (size_t)t * 2 * NVERT;
      const float lxw = uv[tid] * (2.0f * (GV - 1.0f)) - (float)max(2 * j - 2, 0);
      const float lyw = uv[NVERT + tid] * (2.0f * (GV - 1.0f)) - (float)max(2 * i - 2, 0);
      float wyb[3], wxa[3];
      for (int b = 0; b < 3; ++b) {
        wyb[b] = tent(lyw, (float)b);
        wxa[b] = tent(lxw, (float)b);
      }
      float* o = out + (size_t)t * out_per_tile;
#pragma unroll
      for (int ch = 0; ch < MAX_CH; ++ch) {
        if (ch >= channels) break;
        float h = 0.0f;
        for (int b = 0; b < 3; ++b) {
          const int r = tap(i, b);
          for (int a = 0; a < 3; ++a) h = h + wyb[b] * wxa[a] * A[ch][r][tap(j, a)];
        }
        o[ch * NVERT + tid] = h * valid;
      }
    }
    if (fetched) cp_async_wait();
    __syncthreads();  // A is read; a new quad has landed
  }
}

const KernelInstance INSTANCES[] = {
    {"attach_sample_fused[_packed]", (const void*)attach_sample_kernel, 0},
};

}  // namespace

int attach_sample_instances(const KernelInstance** table) {
  *table = INSTANCES;
  return (int)(sizeof(INSTANCES) / sizeof(INSTANCES[0]));
}

// K5a (bits 0, one channel) and K5b, over `waves` times the blocks the card
// holds at once. Launches on the caller's stream; returns cudaGetLastError()
// of the launch (0 on success).
extern "C" int attach_sample_launch(const void* blocks, long long n_blocks, const void* ids,
                                    const void* geom, const void* uvs,
                                    const void* tile_count, int channels, int bits,
                                    void* out, int n_tiles, int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  if (channels < 1 || channels > MAX_CH || (bits != 0 && bits != 8 && bits != 16) ||
      (bits == 0 && channels != 1) || channels * bits > 32 || waves < 1)
    return (int)cudaErrorInvalidValue;
  static int resident[64] = {};
  const int grid = run_grid((const void*)attach_sample_kernel, 0, waves, n_tiles, resident);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  attach_sample_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom, (const float*)uvs,
      (const int*)tile_count, n_tiles, channels, bits, (float*)out);
  return (int)cudaGetLastError();
}
