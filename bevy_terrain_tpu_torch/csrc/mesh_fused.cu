// Fused mesh kernels for Hopper (sm_90a): the whole vertex stage of one
// frame in one launch, for planar terrains and for cube spheres.
//
// Replaces the JAX package's TPU kernel ops/pallas_kernels.py::mesh_fused
// (body _mesh_kernel_body / _mesh_step_compute) in its planar variant (K1)
// and its spherical variant (K2: spherical=True, ellipsoidal, with the
// high-precision step flags; far_geom, taylor_rel and the near-field
// selection). It computes the same function; the TPU kernel's blocking
// does not carry over:
//
// * The TPU kernel streams each frame's unique quads through a VMEM ring
//   (U_MAX / LOOKAHEAD) because a TPU DMA costs ~100 ns to issue. Here each
//   tile block reads its 16 KB quad straight from device memory with 16-byte
//   loads. A frame touches a few hundred unique quads (a few MB) for a few
//   thousand tiles, so repeated reads hit the 50 MB L2: the fetch is L2- and
//   latency-bound. What bounds the kernel on this card is the bytes it must
//   move (the output and the unique quads); the per-tile arithmetic (a 33x33
//   two-tap resample, two 1-2-1 passes, 289 vertices, and for spheres two
//   cube-sphere evaluations and two Taylor chains per vertex) is small.
// * The TPU kernel evaluates the tent resample as dense MXU dots in an
//   evens-first half-grid order (lane slicing). A tent has at most two
//   non-zero taps, so each half-grid point here is a 2x2 bilinear of the
//   mean-centred patch in natural order: the same value as the dense
//   product, without the 64-wide contractions.
// * Tiles run one per thread block (one thread per vertex, 320 threads) in
//   any order; nothing carries between blocks. Dead tiles (index >=
//   tile_count, read from device memory) write zeros, as the TPU kernel
//   zeroes its dead steps. The sphere's high-precision flag stays per
//   64-tile step, as in the TPU kernel: a vertex takes the Taylor near field
//   where its world-frame distance is inside the threshold AND its step
//   (tile index >> 6) is flagged 2, even if its own tile's bound is "far".
//
// Accumulation is f32 (the patch mean is an exact integer sum). Built
// without fast math and without FMA contraction (--fmad=false), so the
// per-vertex chain rounds like the plain PyTorch version's separate ops;
// 1/sqrt is __fdiv_rn(1, __fsqrt_rn(x)), two correctly rounded ops (the
// plain version's sqrt().reciprocal() on the card), not rsqrtf (2 ulp).
//
// Output: (n_tiles, 6, 17, 17) f32 for planar terrains, channels
// [h, px, py, pz, u, v]; (n_tiles, 9, 17, 17) for spheres, adding the unit
// world normal [nx, ny, nz]; in the sorted tile order of the patch plan.

#include <cuda_runtime.h>

namespace {

constexpr int GV = 17;                 // vertices per tile axis (grid_size 16)
constexpr int K = 33;                  // half-grid points per axis
constexpr int P = 64;                  // patch extent in texels
constexpr int QUAD_WORDS = 32 * 128;   // one (32, 128) int32 quad
constexpr int NVERT = GV * GV;         // 289 vertices per tile
constexpr int NTHREADS = 320;          // 10 full warps; threads >= 289 only help load
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILES_PER_STEP = 64;     // tiles per high-precision flag

// spherical tile_params columns (ops/kernels.py SPH_PARAMS): live, lod, x,
// y, side, Taylor c c_s c_t c_ss c_st c_tt (xyz each), origin_xy,
// origin_uv, WM (3x3 row-major), NM (3x3 row-major)
constexpr int TP_TAYLOR = 5, TP_OXY = 23, TP_OUV = 25, TP_WM = 27, TP_NM = 36;
constexpr int SPH_PARAMS = 45;

// cube-sphere warp constant: the JAX kernel sees f32(0.87^2) and
// f32(1 + 0.87^2), each rounded once from the double
constexpr double C_SQR_D = 0.87 * 0.87;

__device__ __forceinline__ float tent(float p, float r) {
  return fmaxf(0.0f, 1.0f - fabsf(p - r));
}

// natural half-grid index of window tap b of vertex i (pallas_kernels.py
// ysel / x-tent rows: 0 for i == 0, else 2i - 2 + b)
__device__ __forceinline__ int tap(int i, int b) { return i == 0 ? 0 : 2 * i - 2 + b; }

__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.0f, __fsqrt_rn(x)); }

struct Vec3 {
  float x, y, z;
};

// Cube-sphere world position + unit world normal at tile uv (uu, vv)
// (pallas_kernels.py far_geom): the warp, the closed-form cube-point norm
// rsqrt(1 + pxs^2 + pys^2), the per-tile side-composed WM rows plus the
// translation fs[3, 7, 11]; normal = pre-translation point / R (fs[42]) for
// a sphere, normalize(NM rows . (pxs, pys, 1)) for an ellipsoid.
template <bool ELLIPSOIDAL>
__device__ __forceinline__ void far_geom(float uu, float vv, float xf, float yf,
                                         float inv_count, const float* tp,
                                         const float* fs, Vec3& w, Vec3& n) {
  const float c = (float)C_SQR_D;
  const float one_c = (float)(1.0 + C_SQR_D);
  const float wxp = 2.0f * ((xf + uu) * inv_count) - 1.0f;
  const float wyp = 2.0f * ((yf + vv) * inv_count) - 1.0f;
  const float pxs = wxp * rsqrt_rn(one_c - c * wxp * wxp);
  const float pys = wyp * rsqrt_rn(one_c - c * wyp * wyp);
  const float inv_n = rsqrt_rn(1.0f + pxs * pxs + pys * pys);
  const float pxn = pxs * inv_n;
  const float pyn = pys * inv_n;
  const float* wm = tp + TP_WM;
  const float sx = wm[0] * pxn + wm[1] * pyn + wm[2] * inv_n;
  const float sy = wm[3] * pxn + wm[4] * pyn + wm[5] * inv_n;
  const float sz = wm[6] * pxn + wm[7] * pyn + wm[8] * inv_n;
  w.x = sx + fs[3];
  w.y = sy + fs[7];
  w.z = sz + fs[11];
  if (ELLIPSOIDAL) {
    const float* nm = tp + TP_NM;
    const float nx = nm[0] * pxs + nm[1] * pys + nm[2];
    const float ny = nm[3] * pxs + nm[4] * pys + nm[5];
    const float nz = nm[6] * pxs + nm[7] * pys + nm[8];
    const float ninv = rsqrt_rn(nx * nx + ny * ny + nz * nz);
    n.x = nx * ninv;
    n.y = ny * ninv;
    n.z = nz * ninv;
  } else {
    n.x = sx * fs[42];
    n.y = sy * fs[42];
    n.z = sz * fs[42];
  }
}

// Taylor view-relative position (pallas_kernels.py taylor_rel): re-anchor
// (xy, uv) at origin_lod with shifts of non-negative int32, so the integer
// parts cancel exactly against the tile's origin_xy, then the second-order
// polynomial in (s, t) = relative position at origin_lod * fs[28]
// (= 2^-origin_lod).
struct Anchor {
  int xi, yi, down, up;
  bool is_dn;
  float scale_dn, scale_up;
};

__device__ __forceinline__ Vec3 taylor_rel(float uu, float vv, const Anchor& a,
                                           const float* tp, const float* fs) {
  float st[2];
  const int ci[2] = {a.xi, a.yi};
  const float cc[2] = {uu, vv};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int o_dn = ci[k] >> a.down;
    const float ou_dn = ((float)(ci[k] & ((1 << a.down) - 1)) + cc[k]) * a.scale_dn;
    const float su = cc[k] * a.scale_up;
    const float fu = floorf(su);
    const int o_up = (ci[k] << a.up) + (int)fu;
    const int oi = a.is_dn ? o_dn : o_up;
    const float ou = a.is_dn ? ou_dn : su - fu;
    st[k] = ((float)(oi - (int)tp[TP_OXY + k]) + (ou - tp[TP_OUV + k])) * fs[28];
  }
  const float s = st[0], t = st[1];
  const float* c = tp + TP_TAYLOR;
  Vec3 r;
  r.x = c[0] + c[3] * s + c[6] * t + c[9] * s * s + c[12] * s * t + c[15] * t * t;
  r.y = c[1] + c[4] * s + c[7] * t + c[10] * s * s + c[13] * s * t + c[16] * t * t;
  r.z = c[2] + c[5] * s + c[8] * t + c[11] * s * s + c[14] * s * t + c[17] * t * t;
  return r;
}

template <bool SPHERICAL, bool ELLIPSOIDAL>
__global__ void __launch_bounds__(NTHREADS)
mesh_fused_kernel(const int* __restrict__ blocks, long long n_blocks,
                  const int* __restrict__ ids,
                  const float* __restrict__ geom,         // (n, 8)
                  const float* __restrict__ tile_params,  // (n, 4) or (n, 45)
                  const float* __restrict__ fs,           // (48,)
                  const int* __restrict__ hp_steps,       // (n / 64,), spheres only
                  const int* __restrict__ tile_count,     // (1,)
                  int origin_lod, float* __restrict__ out) {
  constexpr int OUT_CH = SPHERICAL ? 9 : 6;
  constexpr int OUT_PER_TILE = OUT_CH * GV * GV;
  constexpr int N_PARAMS = SPHERICAL ? SPH_PARAMS : 4;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)t * OUT_PER_TILE;
  if (t >= __ldg(tile_count)) {
    for (int e = tid; e < OUT_PER_TILE; e += NTHREADS) o[e] = 0.0f;
    return;
  }

  __shared__ float patch[P][P];
  __shared__ float H[K][K];   // fine half-grid
  __shared__ float X[K][K];   // H smoothed along x
  __shared__ float Hs[K][K];  // 1-2-1 smoothed half-grid (coarser data lod)
  __shared__ long long warp_sum[NWARPS];
  __shared__ float s_mean;

  // ---- 1. fetch the quad: patch rows 0..31 = q[:, 0:64], rows 32..63 =
  // q[:, 64:128]; exact integer sum for the mean ----
  long long q = ids[t];
  q = q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
  const int4* src = reinterpret_cast<const int4*>(blocks + q * QUAD_WORDS);
  long long acc = 0;
  for (int v = tid; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = __ldg(src + v);
    const int r = v >> 5;          // quad row
    const int c = (v & 31) * 4;    // quad column
    const int pr = r + (c >= P ? 32 : 0);
    const int pc = c & (P - 1);
    patch[pr][pc + 0] = (float)w.x;
    patch[pr][pc + 1] = (float)w.y;
    patch[pr][pc + 2] = (float)w.z;
    patch[pr][pc + 3] = (float)w.w;
    acc += (long long)w.x + w.y + w.z + w.w;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < NWARPS; ++w) total += warp_sum[w];
    s_mean = (float)((double)total / (double)(P * P));
  }
  __syncthreads();
  const float mean = s_mean;

  // ---- 2. tent resample of the mean-centred patch at the 33x33 half-grid
  // positions clip(p0 + k * dp, 0, 63): H = Wy (P - c) Wx^T + c ----
  const float* g = geom + (size_t)t * 8;
  const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3];
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    const float py = fminf(fmaxf(p0y + (float)k * dp, 0.0f), (float)(P - 1));
    const float px = fminf(fmaxf(p0x + (float)l * dp, 0.0f), (float)(P - 1));
    const int r0 = min((int)floorf(py), P - 2);
    const int c0 = min((int)floorf(px), P - 2);
    const float wy0 = tent(py, (float)r0), wy1 = tent(py, (float)(r0 + 1));
    const float wx0 = tent(px, (float)c0), wx1 = tent(px, (float)(c0 + 1));
    const float col0 = wy0 * (patch[r0][c0] - mean) + wy1 * (patch[r0 + 1][c0] - mean);
    const float col1 = wy0 * (patch[r0][c0 + 1] - mean) + wy1 * (patch[r0 + 1][c0 + 1] - mean);
    H[k][l] = (col0 * wx0 + col1 * wx1) + mean;
  }
  __syncthreads();

  // ---- 3. smoothed copy Hs = A H A^T, A = 1-2-1 with duplicated boundary
  // rows (pallas_kernels.py xsmooth / ysmooth) ----
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    X[k][l] = 0.25f * H[k][max(l - 1, 0)] + 0.5f * H[k][l] + 0.25f * H[k][min(l + 1, K - 1)];
  }
  __syncthreads();
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    Hs[k][l] = 0.25f * X[max(k - 1, 0)][l] + 0.5f * X[k][l] + 0.25f * X[min(k + 1, K - 1)][l];
  }
  __syncthreads();

  // ---- 4. per vertex (i = row / v, j = column / u) ----
  if (tid >= NVERT) return;
  const int i = tid / GV, j = tid % GV;
  const float* tp = tile_params + (size_t)t * N_PARAMS;
  const float live = tp[0], lodf = tp[1], xf = tp[2], yf = tp[3];
  const float inv16 = 1.0f / (GV - 1.0f);
  const float u = (float)j * inv16;
  const float v = (float)i * inv16;
  const float inv_count = exp2f(-lodf);

  float d2;
  bool near = false;
  Vec3 w0 = {}, n0 = {};
  Anchor anchor = {};
  if (SPHERICAL) {
    // world-frame view distance^2 at the approximate height fs[29] (view
    // fs[39..41]); on high-precision steps the Taylor distance replaces it
    // inside the threshold (fs[45] = threshold^2)
    far_geom<ELLIPSOIDAL>(u, v, xf, yf, inv_count, tp, fs, w0, n0);
    const float dwx = w0.x + fs[29] * n0.x - fs[39];
    const float dwy = w0.y + fs[29] * n0.y - fs[40];
    const float dwz = w0.z + fs[29] * n0.z - fs[41];
    const float d2_w0 = dwx * dwx + dwy * dwy + dwz * dwz;
    d2 = d2_w0;
    if (hp_steps[t / TILES_PER_STEP] == 2) {
      const int lodi = (int)lodf;
      anchor.xi = (int)xf;
      anchor.yi = (int)yf;
      anchor.down = max(lodi - origin_lod, 0);
      anchor.up = max(origin_lod - lodi, 0);
      anchor.is_dn = lodi >= origin_lod;
      anchor.scale_dn = exp2f(-(float)anchor.down);
      anchor.scale_up = exp2f((float)anchor.up);
      const Vec3 r0 = taylor_rel(u, v, anchor, tp, fs);
      const float dhx = r0.x + fs[29] * n0.x;
      const float dhy = r0.y + fs[29] * n0.y;
      const float dhz = r0.z + fs[29] * n0.z;
      near = d2_w0 < fs[45];
      if (near) d2 = dhx * dhx + dhy * dhy + dhz * dhz;
    }
  } else {
    // planar view distance^2 (fs 0..14: world_from_local, distance base)
    const float lx = (xf + u) * inv_count - 0.5f;
    const float lz = (yf + v) * inv_count - 0.5f;
    const float dx = fs[0] * lx + fs[2] * lz + fs[12];
    const float dy = fs[4] * lx + fs[6] * lz + fs[13];
    const float dz = fs[8] * lx + fs[10] * lz + fs[14];
    d2 = dx * dx + dy * dy + dz * dz;
  }
  const float log2_dist = 0.5f * log2f(d2);

  // CDLOD morph toward the even grid (fs 43 log2(2 morph_distance),
  // fs 19 morph_range, fs 24 morph on)
  const float target_lod = fs[43] - log2_dist;
  float mr = fminf(fmaxf((lodf + fs[19] - target_lod) * (1.0f / fs[19]), 0.0f), 1.0f);
  mr = (lodf == 0.0f ? 0.0f : mr) * fs[24];
  const float even_u = (float)(j & ~1) * inv16;
  const float even_v = (float)(i & ~1) * inv16;
  const float mu = u + (even_u - u) * mr;
  const float mv = v + (even_v - v) * mr;

  // 3x3 tent window at the morphed uv, fine and smoothed slabs
  const float lxw = mu * (2.0f * (GV - 1.0f)) - (float)max(2 * j - 2, 0);
  const float lyw = mv * (2.0f * (GV - 1.0f)) - (float)max(2 * i - 2, 0);
  float wyb[3], wxa[3];
  for (int b = 0; b < 3; ++b) {
    wyb[b] = tent(lyw, (float)b);
    wxa[b] = tent(lxw, (float)b);
  }
  float h_fine = 0.0f, h_smooth = 0.0f;
  for (int b = 0; b < 3; ++b) {
    const int r = tap(i, b);
    for (int a = 0; a < 3; ++a) {
      const int c = tap(j, a);
      const float w = wyb[b] * wxa[a];
      h_fine = h_fine + w * H[r][c];
      h_smooth = h_smooth + w * Hs[r][c];
    }
  }

  // per-vertex blend crossfade (fs 44 log2(blend_distance), 26 lod cap,
  // 21 blend_range, 25 blend on), height (fs 22 min, 23 range / max_value)
  const float btarget = fminf(fs[44] - log2_dist, fs[26]);
  const float blod = (float)(int)fmaxf(btarget, 0.0f);
  const float bratio =
      (blod == 0.0f ? 0.0f
                    : fminf(fmaxf((blod + fs[21] - btarget) * (1.0f / fs[21]), 0.0f), 1.0f)) *
      fs[25];
  const float h_norm = (h_fine + (h_smooth - h_fine) * bratio) * valid;
  const float height = (fs[22] + fs[23] * h_norm) * live;

  const int vtx = i * GV + j;
  float px, py, pz;
  if (SPHERICAL) {
    // world position at the morphed uv; in the near field the Taylor
    // relative position (view + rel) replaces it and the unmorphed normal
    // is kept
    Vec3 wm, nm;
    far_geom<ELLIPSOIDAL>(mu, mv, xf, yf, inv_count, tp, fs, wm, nm);
    if (near) {
      const Vec3 rm = taylor_rel(mu, mv, anchor, tp, fs);
      wm.x = fs[39] + rm.x;
      wm.y = fs[40] + rm.y;
      wm.z = fs[41] + rm.z;
      nm = n0;
    }
    px = wm.x + height * nm.x;
    py = wm.y + height * nm.y;
    pz = wm.z + height * nm.z;
    o[6 * GV * GV + vtx] = nm.x * live;
    o[7 * GV * GV + vtx] = nm.y * live;
    o[8 * GV * GV + vtx] = nm.z * live;
  } else {
    // morphed world position + height along the up normal (fs 15..17)
    const float mlx = (xf + mu) * inv_count - 0.5f;
    const float mlz = (yf + mv) * inv_count - 0.5f;
    px = fs[0] * mlx + fs[2] * mlz + fs[3] + height * fs[15];
    py = fs[4] * mlx + fs[6] * mlz + fs[7] + height * fs[16];
    pz = fs[8] * mlx + fs[10] * mlz + fs[11] + height * fs[17];
  }

  o[0 * GV * GV + vtx] = height;
  o[1 * GV * GV + vtx] = px * live;
  o[2 * GV * GV + vtx] = py * live;
  o[3 * GV * GV + vtx] = pz * live;
  o[4 * GV * GV + vtx] = mu * live;
  o[5 * GV * GV + vtx] = mv * live;
}

}  // namespace

// Launch on the caller's stream. Each returns cudaGetLastError() of the
// launch (0 on success); the kernels allocate nothing and do not
// synchronise.
extern "C" int mesh_fused_planar_launch(const void* blocks, long long n_blocks,
                                        const void* ids, const void* geom,
                                        const void* tile_params, const void* fs,
                                        const void* tile_count, void* out,
                                        int n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  mesh_fused_kernel<false, false><<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
      (const float*)tile_params, (const float*)fs, nullptr, (const int*)tile_count, 0,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int mesh_fused_spherical_launch(const void* blocks, long long n_blocks,
                                           const void* ids, const void* geom,
                                           const void* tile_params, const void* fs,
                                           const void* hp_steps, const void* tile_count,
                                           void* out, int n_tiles, int origin_lod,
                                           int ellipsoidal, void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ellipsoidal) {
    mesh_fused_kernel<true, true><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, (const int*)hp_steps,
        (const int*)tile_count, origin_lod, (float*)out);
  } else {
    mesh_fused_kernel<true, false><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, (const int*)hp_steps,
        (const int*)tile_count, origin_lod, (float*)out);
  }
  return (int)cudaGetLastError();
}
