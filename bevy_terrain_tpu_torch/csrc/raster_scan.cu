// The raster scan for Hopper (sm_90a): per pixel of every level-0 bin, the
// nearest covering candidate of the bin's candidate table.
//
// Replaces no TPU kernel: the JAX package's rasterizer (render/raster.py) is
// an XLA graph with no Pallas kernel. This is the torch scan of the port's
// render/raster.py::_scan as one kernel, bit for bit: the same (best z,
// best triangle) per bin pixel from the same table, coefficients and
// fill-rule flags.
//
// The torch scan evaluates every slot of the (NB, n_chunks * chunk) table,
// -1 or not, as (NB, P, chunk, 4) plane tensors in device memory: its cost
// is NB x sum(caps) x P whatever the scene holds, and it moves hundreds of
// GB a render. What bounds the work is the live candidates' edge tests: per
// live (bin, candidate) pair and bin pixel, four planes (a x + b y) + c
// (8 multiplies, 8 adds), three fill-rule tests and the depth race, about
// 25 instructions; the bytes are the table's live ids and each live
// candidate's 48 bytes of coefficients, read once per bin. The design:
//
// * One block per level-0 bin; a thread owns PPT pixels of it (one up to
//   1024 pixels a bin, more for larger bins) and keeps each one's running
//   (best z, best triangle) and its group's (z, triangle) in registers.
// * _bin_table fills each (level, bin) of the table densely from rank 0, so
//   a level segment of a row is a prefix of triangle ids followed by -1.
//   The block walks its row one segment at a time, in column order, a tile
//   of TILE slots at a time, and stops at the first tile that is not all
//   live: only live candidates are loaded and tested. A -1 slot is a
//   -inf depth in the torch scan and never wins, so skipping it changes no
//   winner.
// * A tile's live ids, their coefficient rows (a, b, c of the planes e0,
//   e1, e2, z) and fill-rule flags are loaded by the block into shared
//   memory, then read by every thread as broadcasts.
// * The torch scan's order semantics: within each group of `chunk` table
//   columns the first maximum wins and a NaN depth wins over any number
//   (torch.max), and a group's winner replaces the running best only when
//   strictly greater (a NaN never is). So a thread keeps the group's
//   (z, triangle) and folds it into the best when the column group
//   changes. Each plane is __fadd_rn(__fadd_rn(__fmul_rn(a, x),
//   __fmul_rn(b, y)), c), the torch ops' roundings, and the library builds
//   with --fmad=false.
//
// Output: (NB, P) f32 best z (-inf where nothing covers) and (NB, P) int64
// best triangle (-1), the torch scan's, for render/raster.py::_resolve.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TILE = 256;        // candidate slots loaded into shared memory at once
constexpr int MAX_THREADS = 1024;
constexpr int MAX_PPT = 4;       // pixels a thread: bins up to 64 x 64 pixels
constexpr int MAX_LEVELS = 32;

// The table's level segments: segment L is columns [start[L], start[L + 1]).
struct Segments {
  int n;
  int start[MAX_LEVELS + 1];
};

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// raster_coverage_rule: e > 0, or e == 0 on a top-left edge
__device__ __forceinline__ bool covers(float e, int flags, int edge) {
  return e > 0.0f || (e == 0.0f && ((flags >> edge) & 1));
}

template <int PPT>
__global__ void __launch_bounds__(MAX_THREADS)
raster_scan_kernel(const long long* __restrict__ table, int width, int nbx, int bin_px,
                   int chunk, Segments seg,
                   const float4* __restrict__ coefs,        // (T, 3) rows a, b, c
                   const unsigned char* __restrict__ top_left,  // (T, 3)
                   float* __restrict__ best_z, long long* __restrict__ best_t) {
  __shared__ float4 s_a[TILE], s_b[TILE], s_c[TILE];
  __shared__ int s_id[TILE], s_flags[TILE], s_group[TILE];

  const int bin = blockIdx.x;
  const int P = bin_px * bin_px;
  const long long* row = table + (size_t)bin * width;
  const float ox = (float)((bin % nbx) * bin_px);
  const float oy = (float)((bin / nbx) * bin_px);

  float x[PPT], y[PPT], bz[PPT], gz[PPT];
  int bt[PPT], gt[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * blockDim.x;
    x[k] = __fadd_rn(ox, (float)(p % bin_px) + 0.5f);
    y[k] = __fadd_rn(oy, (float)(p / bin_px) + 0.5f);
    bz[k] = gz[k] = -INFINITY;
    bt[k] = gt[k] = -1;
  }

  const int tile = min((int)blockDim.x, TILE);
  int group = -1;  // the column group whose winner gz / gt hold
  for (int L = 0; L < seg.n; ++L) {
    const int s0 = seg.start[L], len = seg.start[L + 1] - s0;
    for (int base = 0; base < len; base += tile) {
      const int i = threadIdx.x;
      int id = -1;
      if (i < tile && base + i < len) id = (int)row[s0 + base + i];
      if (id >= 0) {
        s_a[i] = coefs[3 * (size_t)id];
        s_b[i] = coefs[3 * (size_t)id + 1];
        s_c[i] = coefs[3 * (size_t)id + 2];
        const unsigned char* f = top_left + 3 * (size_t)id;
        s_flags[i] = (f[0] ? 1 : 0) | (f[1] ? 2 : 0) | (f[2] ? 4 : 0);
        s_id[i] = id;
        s_group[i] = (s0 + base + i) / chunk;
      }
      const int n = __syncthreads_count(id >= 0);  // the tile's live prefix
      for (int j = 0; j < n; ++j) {
        if (s_group[j] != group) {  // the block's threads all take this branch together
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            if (gz[k] > bz[k]) {
              bz[k] = gz[k];
              bt[k] = gt[k];
            }
            gz[k] = -INFINITY;
          }
          group = s_group[j];
        }
        const float4 A = s_a[j], B = s_b[j], C = s_c[j];
        const int flags = s_flags[j], cand = s_id[j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const bool inside = covers(plane(A.x, B.x, C.x, x[k], y[k]), flags, 0) &&
                              covers(plane(A.y, B.y, C.y, x[k], y[k]), flags, 1) &&
                              covers(plane(A.z, B.z, C.z, x[k], y[k]), flags, 2);
          const float z = plane(A.w, B.w, C.w, x[k], y[k]);
          if (inside && (z > gz[k] || isnan(z))) {
            gz[k] = z;
            gt[k] = cand;
          }
        }
      }
      __syncthreads();  // the tile is read before the next one is loaded
      if (n < tile) break;
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (gz[k] > bz[k]) {
      bz[k] = gz[k];
      bt[k] = gt[k];
    }
    const int p = threadIdx.x + k * blockDim.x;
    if (p < P) {
      best_z[(size_t)bin * P + p] = bz[k];
      best_t[(size_t)bin * P + p] = bt[k];
    }
  }
}

}  // namespace

// The scan of `n_bins` level-0 bins (one block each) on the caller's stream.
// `level_starts` (host memory, n_levels + 1 ints) are the table's level
// segments; `width` the table's row length. Returns cudaGetLastError() of
// the launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take. Allocates nothing and does not synchronise.
extern "C" int raster_scan_launch(const void* table, int n_bins, int width, int nbx,
                                  int bin_px, int chunk, const int* level_starts, int n_levels,
                                  const void* coefs, const void* top_left, void* best_z,
                                  void* best_t, void* stream) {
  if (n_bins <= 0) return 0;
  const int P = bin_px * bin_px;
  if (bin_px < 1 || P > MAX_PPT * MAX_THREADS || chunk < 1 || nbx < 1 || n_levels < 1 ||
      n_levels > MAX_LEVELS || level_starts[n_levels] > width)
    return (int)cudaErrorInvalidValue;
  Segments seg;
  seg.n = n_levels;
  for (int L = 0; L <= n_levels; ++L) seg.start[L] = level_starts[L];
  const int ppt = (P + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = ((P + ppt - 1) / ppt + 31) / 32 * 32;
  const auto args = [&](auto kernel) {
    kernel<<<n_bins, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)table, width, nbx, bin_px, chunk, seg, (const float4*)coefs,
        (const unsigned char*)top_left, (float*)best_z, (long long*)best_t);
  };
  switch (ppt) {
    case 1: args(raster_scan_kernel<1>); break;
    case 2: args(raster_scan_kernel<2>); break;
    case 3: args(raster_scan_kernel<3>); break;
    default: args(raster_scan_kernel<4>); break;
  }
  return (int)cudaGetLastError();
}
