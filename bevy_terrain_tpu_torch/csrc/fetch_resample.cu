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
// grid become one block per tile, any number of tiles in one launch; each
// block reads its quad through L2 with 16-byte loads, as the mesh kernel
// does (a frame touches a few hundred unique quads for a few thousand
// tiles). The TPU's dense MXU dots (wy @ patch, rows @ wx^T, B half B^T)
// are the kernels' own sums here. K6's tents have two taps, so each
// half-grid point is a 2x2 bilinear, and its B products are two 1-2-1
// passes over shared memory; K7's crossfaded weight rows are wider
// (p - dp .. p + dp plus a texel each side), so it forms the 33x64 weight
// rows in shared memory and contracts each over its support, in ascending
// texel order: the dense product's sum without its zero terms. All sums
// are f32 (the TPU ran its dots in bf16 passes), without FMA contraction.
//
// Both are bound by the bytes they move: the unique quads in and 33x33
// floats per tile out (4.4 KB, three quarters of the traffic at frame
// shapes); the arithmetic per tile is a few tens of thousands of
// operations.

#include <cuda_runtime.h>

#include "tile_quad.cuh"

namespace {

constexpr int EVENS = (K + 1) / 2;  // 17 even half-grid indices, then 16 odd

// natural half-grid index of evens-first position i
__device__ __forceinline__ int natural_index(int i) { return i < EVENS ? 2 * i : 2 * i - K; }

__global__ void __launch_bounds__(NTHREADS)
fetch_resample_cached_kernel(const int* __restrict__ blocks, long long n_blocks,
                             const int* __restrict__ ids,
                             const float* __restrict__ geom,      // (n, 8)
                             const int* __restrict__ tile_count,  // (1,)
                             float* __restrict__ out) {           // (n, 33, 33)
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)t * K * K;
  if (t >= __ldg(tile_count)) {
    for (int e = tid; e < K * K; e += NTHREADS) o[e] = 0.0f;
    return;
  }

  __shared__ float patch[P][P];
  __shared__ float H[K][K];  // centred half-grid, natural order
  __shared__ float X[K][K];  // H blended along rows
  __shared__ long long warp_sum[NWARPS];
  __shared__ float s_mean;

  long long q = ids[t];
  q = q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
  const float mean = block_mean(load_patch(blocks + q * QUAD_WORDS, patch), warp_sum, &s_mean);

  const float* g = geom + (size_t)t * 8;
  const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3], ratio = g[4];
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    H[k][l] = centred_bilinear(patch, mean, halfgrid_taps(p0x, p0y, dp, k, l));
  }
  __syncthreads();

  // B H: X = H + ratio (A H - H), A along the rows
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    const float h = H[k][l];
    X[k][l] = h + ratio * (smooth3(H[max(k - 1, 0)][l], h, H[min(k + 1, K - 1)][l]) - h);
  }
  __syncthreads();

  // (B H) B^T along the columns, the mean back, x valid; written in
  // evens-first order (consecutive threads write consecutive floats)
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = natural_index(e / K), l = natural_index(e % K);
    const float x = X[k][l];
    const float y = x + ratio * (smooth3(X[k][max(l - 1, 0)], x, X[k][min(l + 1, K - 1)]) - x);
    o[e] = (y + mean) * valid;
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

__global__ void __launch_bounds__(NTHREADS)
fetch_resample_kernel(const int* __restrict__ blocks, long long n_blocks,
                      const int* __restrict__ ids,     // (n, 4), column 0 drives the load
                      const float* __restrict__ geom,  // (n, 8)
                      float* __restrict__ out) {       // (n, 33, 33)
  const int t = blockIdx.x;
  const int tid = threadIdx.x;

  __shared__ float patch[P][P];
  __shared__ float wy[K][P];
  __shared__ float wx[K][P + 1];  // padded: threads of one warp read different rows
  __shared__ float rows[K][P];
  __shared__ int lo[2][K], hi[2][K];  // support of each weight row: [x, y][k]

  long long q = ids[(size_t)t * 4];
  q = q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
  load_patch(blocks + q * QUAD_WORDS, patch);

  const float* g = geom + (size_t)t * 8;
  const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3], ratio = g[4];
  for (int e = tid; e < 2 * K * P; e += NTHREADS) {
    const int axis = e / (K * P), k = (e % (K * P)) / P, r = e % P;
    const float w = blend_weight(axis ? p0y : p0x, dp, ratio, k, (float)r);
    if (axis) wy[k][r] = w; else wx[k][r] = w;
  }
  // row k's weights are non-zero only between the texels under its three
  // tent centres (rows k - 1, k, k + 1, the boundary rows their own)
  for (int e = tid; e < 2 * K; e += NTHREADS) {
    const int axis = e / K, k = e % K;
    const float p0 = axis ? p0y : p0x;
    const float pa = fminf(fmaxf(p0 + (float)max(k - 1, 0) * dp, 0.0f), (float)(P - 1));
    const float pb = fminf(fmaxf(p0 + (float)min(k + 1, K - 1) * dp, 0.0f), (float)(P - 1));
    lo[axis][k] = (int)floorf(fminf(pa, pb));
    hi[axis][k] = min((int)floorf(fmaxf(pa, pb)) + 1, P - 1);
  }
  __syncthreads();

  // rows = wy patch
  for (int e = tid; e < K * P; e += NTHREADS) {
    const int k = e / P, c = e % P;
    float acc = 0.0f;
    for (int r = lo[1][k]; r <= hi[1][k]; ++r) acc = acc + wy[k][r] * patch[r][c];
    rows[k][c] = acc;
  }
  __syncthreads();

  // half = rows wx^T, x valid, natural order
  float* o = out + (size_t)t * K * K;
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    float acc = 0.0f;
    for (int c = lo[0][l]; c <= hi[0][l]; ++c) acc = acc + rows[k][c] * wx[l][c];
    o[e] = acc * valid;
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

// Launch on the caller's stream. Each returns cudaGetLastError() of the
// launch (0 on success); the kernels allocate nothing and do not
// synchronise.
extern "C" int fetch_resample_cached_launch(const void* blocks, long long n_blocks,
                                            const void* ids, const void* geom,
                                            const void* tile_count, void* out, int n_tiles,
                                            void* stream) {
  if (n_tiles <= 0) return 0;
  fetch_resample_cached_kernel<<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
      (const int*)tile_count, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int fetch_resample_launch(const void* blocks, long long n_blocks, const void* ids,
                                     const void* geom, void* out, int n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  fetch_resample_kernel<<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom, (float*)out);
  return (int)cudaGetLastError();
}
