// Half-grid kernels for Hopper (sm_90a): the patch fetch fused with the
// 33x33 tent resample, for the staged mesh path.
//
// Replaces the JAX package's TPU kernels ops/pallas_kernels.py::
// fetch_resample_cached (K6, body _kernel_cached / _resample_one) and
// fetch_resample (K7, body _kernel). Per tile both fetch the 16 KB quad of
// the tile's patch, assemble the 64x64 patch and resample it at the 33x33
// half-grid positions clip(p0 + k * dp, 0, 63), blended toward the coarser
// data lod by the tile's ratio, x valid. They differ in the blend and in
// the output order:
//
// * K6 resamples the mean-centred patch, blends the VALUES on both sides,
//   B H B^T with B = I + ratio (A - I), A the 1-2-1 smoothing with
//   duplicated boundary rows, adds the mean back, and writes rows and
//   columns evens-first ([0, 2, .., 32, 1, 3, .., 31]), the order the
//   per-vertex 3x3 window reads. Tiles at index >= tile_count (read from
//   device memory) come out as zeros.
// * K7 crossfades the tent WEIGHTS with their 1-2-1 form,
//   0.25 t(p - dp) + 0.5 t(p) + 0.25 t(p + dp) (the boundary rows keep
//   t(p)), contracts the weight rows with the patch, and writes natural
//   order. Only column 0 of its (F, 4) ids drives the fetch.
//
// They compute what the TPU kernels compute; the TPU's mechanics do not
// carry over. K6's VMEM ring of unique quads with its DMA look-ahead,
// K7's 1024-tile chunks (a scalar-memory limit) and the 64-tiles-per-step
// grid become runs of tiles per block: a block walks an equal run of
// consecutive tiles on a grid of HALFGRID_WAVES waves of the blocks the
// card holds at once (tile_quad.cuh tile_run / run_grid), keeps the quad it
// holds while the ids repeat, and copies the next tile's quad with
// cp.async behind the current tile. The TPU's dense MXU dots (wy @ patch,
// rows @ wx^T, B half B^T) are the kernels' own sums here, over their
// non-zero terms in ascending texel order; the grid and the run lengths do
// not change a bit of the output. All sums are f32 (the TPU ran its dots in
// bf16 passes), without FMA contraction.
//
// Both are bound by the bytes they move: the unique quads in and 33x33
// floats per tile out (4.4 KB, three quarters of K6's traffic at frame
// shapes). K6 holds a quad for ~15 tiles of a frame, unpacked once into a
// float patch with its exact mean. Its two-tap tents make each half-grid
// point a 2x2 bilinear: a thread's strip of four points down one column
// forms the column's x taps once and the blend along k in registers, and
// reads the rows' y taps from a table that the threads past the strips
// build for the next tile while the others write this one. K7's inputs
// repeat few quads (the sweep tool's random ids), so its per-tile fetch
// lands behind the previous tile; its crossfaded weight rows are formed
// only over their supports (a few texels a row, packed) and the rows pass
// covers only the columns the x supports reach. No tensor cores: the dense
// products would be mostly zeros, and TF32 or bf16 would not give the f32
// plain version's bits.

#include <cuda_runtime.h>

#include "tile_quad.cuh"

namespace {

constexpr int EVENS = (K + 1) / 2;  // 17 even half-grid indices, then 16 odd

// natural half-grid index of evens-first position i, and back
__device__ __forceinline__ int natural_index(int i) { return i < EVENS ? 2 * i : 2 * i - K; }
__device__ __forceinline__ int evens_first(int k) { return (k & 1) ? EVENS + (k >> 1) : k >> 1; }

// The y taps of one half-grid row (AxisTaps), one 16-byte load.
struct alignas(16) RowTaps {
  int i0;
  float w0, w1, pad;
};

// A thread past the strips (tid >= K * STRIPS) fills rows tid - K * STRIPS,
// + (NTHREADS - K * STRIPS), .. of a tile's y tap table.
__device__ __forceinline__ void row_taps(int tid, float p0y, float dp, RowTaps* table) {
  for (int k = tid - K * STRIPS; k < K; k += NTHREADS - K * STRIPS) {
    const AxisTaps y = axis_taps(p0y, dp, k);
    table[k] = {y.i0, y.w0, y.w1, 0.0f};
  }
}

// K6's shared memory.
struct CachedShared {
  alignas(16) int raw[QUAD_WORDS];  // the next quad, raw (32, 128): the cp.async target
  float patch[P][P];                // the held quad, natural texel order
  float X[K][K];                    // the centred half-grid blended along k, evens-first
  RowTaps ytap[2][K];               // the y taps of this tile and of the next
  long long warp_sum[NWARPS];
  float mean;
};

// K6: runs of tiles per block, built for four blocks per SM. The held quad
// is a float patch, its exact mean taken once; the next tile's quad, when
// its id differs, is copied raw behind the whole current tile and unpacked
// at the top of the next. Two barriers a tile.
__global__ void __launch_bounds__(NTHREADS, 4)
fetch_resample_cached_kernel(const int* __restrict__ blocks, long long n_blocks,
                             const int* __restrict__ ids,
                             const float* __restrict__ geom,      // (n, 8)
                             const int* __restrict__ tile_count,  // (1,)
                             int n_tiles, float* __restrict__ out) {  // (n, 33, 33)
  __shared__ CachedShared s;
  const TileRun run = tile_run(n_tiles, __ldg(tile_count));
  long long q = 0;
  if (run.t0 < run.t1) {
    q = quad_id(ids, run.t0, n_blocks);
    fetch_quad_async(s.raw, blocks + q * QUAD_WORDS);
  }
  // the dead tiles' zeros go out while the first quad lands
  zero_fill(out + (size_t)run.d0 * K * K, out + (size_t)run.d1 * K * K);
  if (run.t0 == run.t1) return;
  if (threadIdx.x >= K * STRIPS)
    row_taps(threadIdx.x, geom[(size_t)run.t0 * 8 + 1], geom[(size_t)run.t0 * 8 + 2], s.ytap[0]);
  cp_async_wait();
  __syncthreads();
  bool fetched = true;  // s.raw holds quad q: unpack it and take its mean
  float mean = 0.0f;
  for (int t = run.t0; t < run.t1; ++t) {
    const int tid = opaque((int)threadIdx.x);
    if (fetched) {
      mean = block_mean(unpack_patch(s.raw, s.patch), s.warp_sum, &s.mean);
      fetched = false;
    }
    // s.raw is free: the next tile's quad, if another, lands behind this tile
    const long long next = t + 1 < run.t1 ? quad_id(ids, t + 1, n_blocks) : q;
    if (next != q) fetch_quad_async(s.raw, blocks + next * QUAD_WORDS);
    const int slot = (t - run.t0) & 1;
    // past the strips: the next tile's p0y and dp, for its y tap table
    float ahead_p0y = 0.0f, ahead_dp = 0.0f;
    if (tid >= K * STRIPS && t + 1 < run.t1) {
      ahead_p0y = geom[(size_t)(t + 1) * 8 + 1];
      ahead_dp = geom[(size_t)(t + 1) * 8 + 2];
    }

    // ---- 1. the strip's centred half-grid H (patch - mean through the
    // two-by-two taps) at rows k0 - 1 .. k0 + STRIP, clamped, then B H along
    // k: X = H + ratio (A H - H), stored evens-first ----
    const float* g = geom + (size_t)t * 8;
    const float p0x = g[0], dp = g[2], valid = g[3], ratio = g[4];
    if (tid < K * STRIPS) {
      const int l = tid % K, k0 = tid / K * STRIP;
      const AxisTaps x = axis_taps(p0x, dp, l);
      float h[STRIP + 2];
#pragma unroll
      for (int d = 0; d < STRIP + 2; ++d) {
        const RowTaps y = s.ytap[slot][min(max(k0 - 1 + d, 0), K - 1)];
        h[d] = centred_bilinear(s.patch, mean, {y.i0, x.i0, y.w0, y.w1, x.w0, x.w1});
      }
#pragma unroll
      for (int d = 0; d < STRIP; ++d) {
        if (k0 + d >= K) break;
        s.X[evens_first(k0 + d)][evens_first(l)] =
            h[d + 1] + ratio * (smooth3(h[d], h[d + 1], h[d + 2]) - h[d + 1]);
      }
    }
    __syncthreads();

    // ---- 2. (B H) B^T along l, the mean back, x valid: a thread takes
    // evens-first column j of rows i, i + 9, ..; consecutive threads write
    // consecutive floats ----
    if (tid < K * STRIPS) {
      const int j = tid % K, l = natural_index(j);
      const int jm = evens_first(max(l - 1, 0)), jp = evens_first(min(l + 1, K - 1));
      float* o = out + (size_t)t * K * K + j;
      for (int i = tid / K; i < K; i += STRIPS) {
        const float x = s.X[i][j];
        const float y = x + ratio * (smooth3(s.X[i][jm], x, s.X[i][jp]) - x);
        o[i * K] = (y + mean) * valid;
      }
    } else if (t + 1 < run.t1) {  // past the strips: the next tile's y taps
      row_taps(tid, ahead_p0y, ahead_dp, s.ytap[slot ^ 1]);
    }
    if (next != q) {
      cp_async_wait();
      q = next;
      fetched = true;
    }
    __syncthreads();  // X and the patch are read; the next quad has landed
  }
}

// Weight of texel r in row k of the crossfaded tent matrix of one axis
// (pallas_kernels.py _kernel weights()).
__device__ __forceinline__ float blend_weight(float p0, float dp, float ratio, int k, float r) {
  const float kf = (float)k;
  const float w = tent(fminf(fmaxf(p0 + kf * dp, 0.0f), (float)(P - 1)), r);
  const float wm =
      k == 0 ? w : tent(fminf(fmaxf(p0 + (kf + -1.0f) * dp, 0.0f), (float)(P - 1)), r);
  const float wp =
      k == K - 1 ? w : tent(fminf(fmaxf(p0 + (kf + 1.0f) * dp, 0.0f), (float)(P - 1)), r);
  const float w2 = 0.25f * wm + 0.5f * w + 0.25f * wp;
  return w + (w2 - w) * ratio;
}

// The support of weight row k of one axis: the texels [lo, hi] under its
// tent centres, rows k - 1 .. k + 1 (the boundary rows their own). Every
// weight outside it is +0.
struct Support {
  int lo, hi;
};

__device__ __forceinline__ Support row_support(float p0, float dp, int k) {
  const float pa = fminf(fmaxf(p0 + (float)max(k - 1, 0) * dp, 0.0f), (float)(P - 1));
  const float pb = fminf(fmaxf(p0 + (float)min(k + 1, K - 1) * dp, 0.0f), (float)(P - 1));
  return {(int)floorf(fminf(pa, pb)), min((int)floorf(fmaxf(pa, pb)) + 1, P - 1)};
}

// The clipped positions are monotone in k, so the supports' widths of one
// axis sum to at most 2 (floor(p_32) - floor(p_0)) + 2 K: this many floats
// hold its packed weight rows.
constexpr int MAX_SUPPORT = 2 * (P - 1) + 2 * K;

// K7's shared memory.
struct SweepShared {
  alignas(16) int quad[2][QUAD_WORDS];  // the current tile's quad and the next, raw
  float rows[K][P];                     // wy patch, over the columns the x supports reach
  float w[2][MAX_SUPPORT];              // [x, y]: weight row k at w[base[k] ..)
  int lo[2][K];                         // the first texel of each row's support
  int base[2][K + 1];                   // row k's weights; base[K] is the total
};

// The packed weight rows of one axis, from one warp: lane k forms row k
// (lane 31 rows 31 and 32) over its support. A warp scan of the widths
// gives each row's offset.
__device__ __forceinline__ void weight_rows(float p0, float dp, float ratio, int lane,
                                            int* lo, int* base, float* w) {
  const Support a = row_support(p0, dp, lane);
  const Support b = lane == 31 ? row_support(p0, dp, K - 1) : Support{0, -1};
  const int na = a.hi - a.lo + 1, n = na + (b.hi - b.lo + 1);
  int end = n;  // inclusive scan: the end of this lane's rows
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, end, off);
    if (lane >= off) end += v;
  }
  const int start = end - n;
  lo[lane] = a.lo;
  base[lane] = start;
  for (int r = a.lo; r <= a.hi; ++r)
    w[start + r - a.lo] = blend_weight(p0, dp, ratio, lane, (float)r);
  if (lane == 31) {
    lo[K - 1] = b.lo;
    base[K - 1] = start + na;
    base[K] = end;
    for (int r = b.lo; r <= b.hi; ++r)
      w[start + na + r - b.lo] = blend_weight(p0, dp, ratio, K - 1, (float)r);
  }
}

// K7: runs of tiles per block, built for four blocks per SM. Two raw quad
// buffers: the current tile reads one while the next tile's quad, when its
// id differs, is copied into the other. Three barriers a tile.
__global__ void __launch_bounds__(NTHREADS, 4)
fetch_resample_kernel(const int* __restrict__ blocks, long long n_blocks,
                      const int* __restrict__ ids,     // (n, 4), column 0 drives the load
                      const float* __restrict__ geom,  // (n, 8)
                      int n_tiles, float* __restrict__ out) {  // (n, 33, 33)
  __shared__ SweepShared s;
  const TileRun run = tile_run(n_tiles, n_tiles);
  if (run.t0 == run.t1) return;
  long long q = quad_id(ids, run.t0, n_blocks, 4);
  fetch_quad_async(s.quad[0], blocks + q * QUAD_WORDS);
  cp_async_wait();
  __syncthreads();
  int cur = 0;  // s.quad[cur] holds quad q
  for (int t = run.t0; t < run.t1; ++t) {
    const int tid = opaque((int)threadIdx.x);
    const long long next = t + 1 < run.t1 ? quad_id(ids, t + 1, n_blocks, 4) : q;
    if (next != q) fetch_quad_async(s.quad[cur ^ 1], blocks + next * QUAD_WORDS);

    // ---- 1. the weight rows over their supports: warp 0 x, warp 1 y ----
    const float* g = geom + (size_t)t * 8;
    const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3], ratio = g[4];
    if (tid < 64) {
      const int axis = tid >> 5;
      weight_rows(axis ? p0y : p0x, dp, ratio, tid & 31, s.lo[axis], s.base[axis],
                  s.w[axis]);
    }
    __syncthreads();

    // ---- 2. rows = wy patch over the columns [c0, c1] that the x supports
    // reach (the positions are monotone: rows 0 and 32 hold the ends) ----
    const int* quad = s.quad[cur];
    const int x_end = s.lo[0][K - 1] + (s.base[0][K] - s.base[0][K - 1]) - 1;
    const int x_first = s.lo[0][0] + (s.base[0][1] - s.base[0][0]) - 1;
    const int c0 = min(s.lo[0][0], s.lo[0][K - 1]), c1 = max(x_first, x_end);
    for (int c = c0 + (tid & 31); c <= c1; c += 32) {
      for (int k = tid >> 5; k < K; k += NWARPS) {  // a warp a row: one texel row a tap
        const int lo = s.lo[1][k], b = s.base[1][k], n = s.base[1][k + 1] - b;
        float acc = 0.0f;
        for (int j = 0; j < n; ++j)
          acc = acc + s.w[1][b + j] * (float)(int)quad_texel(quad, lo + j, c);
        s.rows[k][c] = acc;
      }
    }
    __syncthreads();

    // ---- 3. half = rows wx^T over each x support, x valid, natural order:
    // a strip of rows down one column l, the column's weights in registers
    // (up to four; a wider support reads them from shared memory) ----
    if (tid < K * STRIPS) {
      const int l = tid % K, k0 = tid / K * STRIP;
      const int lo = s.lo[0][l], b = s.base[0][l], n = s.base[0][l + 1] - b;
      float wx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wx[j] = j < n ? s.w[0][b + j] : 0.0f;
      float* o = out + (size_t)t * K * K + l;
#pragma unroll
      for (int d = 0; d < STRIP; ++d) {
        const int k = k0 + d;
        if (k >= K) break;
        float acc = 0.0f;
        if (n <= 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < n) acc = acc + s.rows[k][lo + j] * wx[j];
        } else {
          for (int j = 0; j < n; ++j) acc = acc + s.rows[k][lo + j] * s.w[0][b + j];
        }
        o[k * K] = acc * valid;
      }
    }
    if (next != q) {
      cp_async_wait();
      q = next;
      cur ^= 1;
    }
    __syncthreads();  // rows and weights are read; the next quad has landed
  }
}

const KernelInstance INSTANCES[] = {
    {"fetch_resample_cached", (const void*)fetch_resample_cached_kernel, 0},
    {"fetch_resample", (const void*)fetch_resample_kernel, 0},
};

}  // namespace

int fetch_resample_instances(const KernelInstance** table) {
  *table = INSTANCES;
  return (int)(sizeof(INSTANCES) / sizeof(INSTANCES[0]));
}

// Launch on the caller's stream, on `waves` times the blocks the card holds
// at once. Each returns cudaGetLastError() of the launch (0 on success); the
// kernels allocate nothing and do not synchronise.
extern "C" int fetch_resample_cached_launch(const void* blocks, long long n_blocks,
                                            const void* ids, const void* geom,
                                            const void* tile_count, void* out, int n_tiles,
                                            int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  if (waves < 1) return (int)cudaErrorInvalidValue;
  static int resident[64] = {};
  const int grid =
      run_grid((const void*)fetch_resample_cached_kernel, 0, waves, n_tiles, resident);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  fetch_resample_cached_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
      (const int*)tile_count, n_tiles, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int fetch_resample_launch(const void* blocks, long long n_blocks, const void* ids,
                                     const void* geom, void* out, int n_tiles, int waves,
                                     void* stream) {
  if (n_tiles <= 0) return 0;
  if (waves < 1) return (int)cudaErrorInvalidValue;
  static int resident[64] = {};
  const int grid = run_grid((const void*)fetch_resample_kernel, 0, waves, n_tiles, resident);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  fetch_resample_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom, n_tiles,
      (float*)out);
  return (int)cudaGetLastError();
}
