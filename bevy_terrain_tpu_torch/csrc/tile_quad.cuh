// What the tile kernels (mesh_fused.cu, attach_sample.cu, fetch_resample.cu)
// share: the block-quad layout, the 33x33 half-grid tents and strips, the
// 1-2-1 smoothing tap and the 3x3 vertex window; and, for a block's run of
// tiles, the asynchronous quad fetch into shared memory, the packed
// channels of one half-grid point, the exact channel means and the zero
// fill of dead tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GV = 17;                // vertices per tile axis (grid_size 16)
constexpr int K = 33;                 // half-grid points per axis
constexpr int P = 64;                 // patch extent in texels
constexpr int QUAD_WORDS = 32 * 128;  // one (32, 128) int32 quad
constexpr int NVERT = GV * GV;        // 289 vertices per tile
constexpr int NTHREADS = 320;         // 10 full warps; threads >= 289 only help load
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_CH = 4;             // packed channels per int32 word
constexpr int MAX_SUMS = MAX_CH + 1;  // the height's sum and an albedo's channel sums

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

// channel c of a word as an exact integer (bits 0: the raw signed word)
__device__ __forceinline__ long long field(int word, int c, int bits) {
  if (bits == 0) return word;
  return ((unsigned)word >> (bits * c)) & ((1u << bits) - 1u);
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two non-zero taps of half-grid point (k, l) of a tile: texel rows
// r0, r0 + 1 and columns c0, c0 + 1 of the patch, with their tent weights
// (positions clip(p0 + k * dp, 0, 63)).
struct Taps {
  int r0, c0;
  float wy0, wy1, wx0, wx1;
};

// The taps along one axis: half-grid index k at position clip(p0 + k * dp,
// 0, 63) -> texel i0 and weights w0 (texel i0) and w1 (texel i0 + 1).
struct AxisTaps {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ AxisTaps axis_taps(float p0, float dp, int k) {
  const float p = fminf(fmaxf(p0 + (float)k * dp, 0.0f), (float)(P - 1));
  const int i0 = min((int)floorf(p), P - 2);
  return {i0, tent(p, (float)i0), tent(p, (float)(i0 + 1))};
}

// A half-grid pass of K1, K2 or K6 gives each thread a strip of STRIP
// points down one column l, rows k0 .. k0 + STRIP - 1: thread tid < K *
// STRIPS takes l = tid % K, k0 = tid / K * STRIP. 33 columns x 9 strips =
// 297 threads.
constexpr int STRIP = 4;
constexpr int STRIPS = (K + STRIP - 1) / STRIP;

__device__ __forceinline__ Taps halfgrid_taps(float p0x, float p0y, float dp, int k, int l) {
  const AxisTaps y = axis_taps(p0y, dp, k), x = axis_taps(p0x, dp, l);
  return {y.i0, x.i0, y.w0, y.w1, x.w0, x.w1};
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

// A quad held raw in shared memory (fetch_quad_async) as floats in natural
// texel order in `patch`, 16-byte stores. Returns this thread's share of the
// exact integer texel sum.
__device__ __forceinline__ long long unpack_patch(const int* q, float (*patch)[P]) {
  const int4* src = reinterpret_cast<const int4*>(q);
  long long acc = 0;
  for (int v = threadIdx.x; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = src[v];
    int pr, pc;
    quad_to_patch(v, pr, pc);
    *reinterpret_cast<float4*>(&patch[pr][pc]) =
        make_float4((float)w.x, (float)w.y, (float)w.z, (float)w.w);
    acc += (long long)w.x + w.y + w.z + w.w;
  }
  return acc;
}

// The patch mean from the threads' shares of the texel sum (unpack_patch):
// an exact integer sum, divided once. Every thread of the block calls it
// and gets the mean; it ends with a barrier, after which the patch is
// visible to all threads. warp_sum (NWARPS) and s_mean are shared
// scratch.
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

// ---- the run-of-tiles kernels: a block walks consecutive tiles of the
// plan's order and fetches a quad only when the tile's id differs from the
// one it holds. The quad stays in shared memory in its raw (32, 128)
// layout. ----

// Start the copy of one quad (QUAD_WORDS int32, 16-byte aligned at both
// ends) into shared memory: 16-byte cp.async by every thread of the block,
// through L2. cp_async_wait then a barrier make it visible.
__device__ __forceinline__ void fetch_quad_async(int* dst, const int* __restrict__ src) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int v = threadIdx.x; v < QUAD_WORDS / 4; v += NTHREADS) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * v),
                 "l"(src + 4 * v)
                 : "memory");
  }
}

// Wait for this thread's outstanding cp.async copies.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x, hidden from the optimizer. A run-of-tiles kernel reads its thread
// index and its frame scalars through this once per tile, so that what it
// computes from them (half-grid and vertex indices, loads of the frame and
// material constants) stays inside the tile loop instead of being hoisted
// out of it, where it would hold registers across every tile.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Patch texel (pr, pc) of a raw quad: quad rows hold patch rows 0..31 in
// columns 0:64 and patch rows 32..63 in columns 64:128.
__device__ __forceinline__ unsigned quad_texel(const int* q, int pr, int pc) {
  return (unsigned)q[(pr & 31) * 128 + ((pr & 32) << 1) + pc];
}

// The four texels under the taps of one half-grid point: (r0, c0),
// (r0 + 1, c0), (r0, c0 + 1), (r0 + 1, c0 + 1).
struct Corners {
  unsigned w00, w10, w01, w11;
};

__device__ __forceinline__ Corners quad_corners(const int* q, const Taps& tw) {
  return {quad_texel(q, tw.r0, tw.c0), quad_texel(q, tw.r0 + 1, tw.c0),
          quad_texel(q, tw.r0, tw.c0 + 1), quad_texel(q, tw.r0 + 1, tw.c0 + 1)};
}

// Every channel of one half-grid point from its four words, read once:
// a[ch * K * K] = the point's value of channel ch. Exact: the mean-centred
// f32 resample, Wy (T - m) Wx^T + m with the channel's exact mean m (bits
// 0 and one channel: the height). Fast (8-bit channels, the TPU kernel's
// bf16 MXU path): tent weights rounded to bf16, no centring, each two-term
// y sum in f32 rounded to bf16, then the x sum in f32. A tent has at most
// two taps and a byte times a bf16 weight is exact in f32, so each sum
// rounds once, as on the TPU.
__device__ __forceinline__ void halfgrid_channels(const Corners& w, const Taps& tw,
                                                  int channels, int bits, bool fast,
                                                  const float* mean, float* a) {
#pragma unroll
  for (int ch = 0; ch < MAX_CH; ++ch) {
    if (ch >= channels) break;
    const float t00 = unpack(w.w00, ch, bits), t10 = unpack(w.w10, ch, bits);
    const float t01 = unpack(w.w01, ch, bits), t11 = unpack(w.w11, ch, bits);
    if (fast) {
      const float by0 = bf16_rn(tw.wy0), by1 = bf16_rn(tw.wy1);
      const float row0 = bf16_rn(by0 * t00 + by1 * t10);
      const float row1 = bf16_rn(by0 * t01 + by1 * t11);
      a[ch * K * K] = row0 * bf16_rn(tw.wx0) + row1 * bf16_rn(tw.wx1);
    } else {
      const float m = mean[ch];
      const float col0 = tw.wy0 * (t00 - m) + tw.wy1 * (t10 - m);
      const float col1 = tw.wy0 * (t01 - m) + tw.wy1 * (t11 - m);
      a[ch * K * K] = (col0 * tw.wx0 + col1 * tw.wx1) + m;
    }
  }
}

// Add this thread's share of the exact integer sums of `channels` channels
// of a raw quad in shared memory to acc[0 .. channels).
__device__ __forceinline__ void quad_sums(const int* q, int channels, int bits,
                                          long long* acc) {
  const int4* src = reinterpret_cast<const int4*>(q);
  for (int v = threadIdx.x; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = src[v];
#pragma unroll
    for (int ch = 0; ch < MAX_CH; ++ch)
      if (ch < channels)
        acc[ch] += field(w.x, ch, bits) + field(w.y, ch, bits) + field(w.z, ch, bits) +
                 field(w.w, ch, bits);
  }
}

// The means of n exact integer sums from the threads' shares acc[0 .. n):
// each total divided once. Every thread of the block calls it; it ends with
// a barrier, after which mean[0 .. n) is visible. warp_sum is shared
// scratch.
__device__ __forceinline__ void block_means(long long* acc, int n,
                                            long long (*warp_sum)[MAX_SUMS], float* mean) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < MAX_SUMS; ++c) {
    if (c >= n) break;
    long long a = acc[c];
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if ((tid & 31) == 0) warp_sum[tid >> 5][c] = a;
  }
  __syncthreads();
  if (tid < n) {
    long long total = 0;
    for (int w = 0; w < NWARPS; ++w) total += warp_sum[w][tid];
    mean[tid] = (float)((double)total / (double)(P * P));
  }
  __syncthreads();
}

// Zeros over [begin, end) from the whole block: 16-byte stores between the
// unaligned head and tail.
__device__ __forceinline__ void zero_fill(float* begin, float* end) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(begin), e = reinterpret_cast<uintptr_t>(end);
  const uintptr_t up = (b + 15) & ~uintptr_t(15), down = e & ~uintptr_t(15);
  const uintptr_t b16 = up < e ? up : e;
  const uintptr_t e16 = down > b16 ? down : b16;
  float4* body = reinterpret_cast<float4*>(b16);
  const int n16 = (int)((e16 - b16) / 16);
  for (int v = threadIdx.x; v < n16; v += NTHREADS) body[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int head = (int)((b16 - b) / 4), tail = (int)((e - e16) / 4);
  if ((int)threadIdx.x < head) begin[threadIdx.x] = 0.0f;
  else if ((int)threadIdx.x < head + tail)
    reinterpret_cast<float*>(e16)[threadIdx.x - head] = 0.0f;
}

// The tiles of one block of a run-of-tiles kernel: the live tiles [0,
// tile_count) and the dead ones [tile_count, n_tiles) are each split into
// gridDim.x contiguous runs of near-equal length, so every block has the
// same work (no tail wave) and a run keeps the plan's order; this block
// takes the live tiles [t0, t1) and the dead ones [d0, d1).
struct TileRun {
  int t0, t1, d0, d1;
};

__device__ __forceinline__ TileRun tile_run(int n_tiles, int tile_count) {
  const long long live = tile_count < 0 ? 0 : (tile_count > n_tiles ? n_tiles : tile_count);
  const long long dead = n_tiles - live, b = blockIdx.x, g = gridDim.x;
  return {(int)(live * b / g), (int)(live * (b + 1) / g), (int)(live + dead * b / g),
          (int)(live + dead * (b + 1) / g)};
}

// The blocks of NTHREADS threads the current card holds at once for
// `kernel` at `smem` bytes of dynamic shared memory (SMs x blocks per SM),
// or 0 on an error.
inline int resident_blocks(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// The grid of a run-of-tiles kernel: `waves` times the blocks the card
// holds at once (`resident`, per device, filled at first use), at most one
// block per tile. 0 on an error.
inline int run_grid(const void* kernel, int smem, int waves, int n_tiles, int* resident) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!resident[dev]) resident[dev] = resident_blocks(kernel, smem);
  const long long grid = (long long)waves * resident[dev];
  return (int)(grid < n_tiles ? grid : n_tiles);
}

// quad id of tile t (ids[t * stride]), clamped into the block array
__device__ __forceinline__ long long quad_id(const int* __restrict__ ids, int t,
                                             long long n_blocks, int stride = 1) {
  const long long q = ids[(size_t)t * stride];
  return q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
}

}  // namespace

// One kernel instance of the library, for the occupancy query
// (occupancy.cu): its name, its entry and its dynamic shared memory.
struct KernelInstance {
  const char* name;
  const void* fn;
  int dynamic_smem;
};

// Each source's instances: returns the count and points *table at them.
int mesh_fused_instances(const KernelInstance** table);
int attach_sample_instances(const KernelInstance** table);
int fetch_resample_instances(const KernelInstance** table);
