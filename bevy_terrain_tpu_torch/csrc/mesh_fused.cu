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
//
// The planar kernel also has the material variants of the same TPU kernel:
//
// * K3, albedo (mesh_fused with albedo_channels / albedo_bits / albedo_fast /
//   albedo_combined): per tile a second 16 KB quad of packed texels (C
//   channels of B bits in one int32 word, channel c in bits [cB, (c+1)B)),
//   from its own block array or from rows 32:64 of a combined (N, 64, 128)
//   array, resampled with the height's tents and read at the morphed uv
//   through the height's window weights; C rows of raw texel values
//   x valid x live follow the mesh rows: (n_tiles, 6 + C, 17, 17). The exact
//   path is K1's mean-centred f32 resample per channel. The fast path
//   (B = 8) is the TPU kernel's bf16 MXU path emulated on the CUDA cores:
//   tent weights rounded to bf16 (round to nearest even), no centring, the
//   y contraction summed in f32 and rounded to bf16, then the x contraction
//   in f32. A tent has at most two taps and a byte times a bf16 weight is
//   exact in f32, so each sum rounds once, as on the TPU.
// * K4, shaded (mesh_fused with shade=, _kernel_pbr_shade): K3 plus the
//   fragment stage on the per-vertex values already in registers --
//   central-difference normals over the tile's heights (one-sided at the
//   tile edge, as the TPU kernel's clamped lane shift), Filament GGX +
//   Smith + Schlick + Burley for any number of directional / point / spot
//   lights, emissive and ambient. The material is a small f32 buffer
//   (ops/kernels.py pack_shade_spec), read per launch: no rebuild per
//   material and no cap on the light count.
//
// Channels, bits, fast and combined are launch arguments, uniform across
// the grid; only ALBEDO and SHADE are template parameters. K1's phases
// compile unchanged in every instance, so the mesh rows of K3 and K4 are
// bit-identical to K1's on the same inputs. Shared memory stays static
// (under 48 KB): the albedo quad reuses the height patch buffer once the
// height resample is done, and the shade's height grid reuses X once the
// smoothing is done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_quad.cuh"

namespace {

constexpr int TILES_PER_STEP = 64;     // tiles per high-precision flag

// spherical tile_params columns (ops/kernels.py SPH_PARAMS): live, lod, x,
// y, side, Taylor c c_s c_t c_ss c_st c_tt (xyz each), origin_xy,
// origin_uv, WM (3x3 row-major), NM (3x3 row-major)
constexpr int TP_TAYLOR = 5, TP_OXY = 23, TP_OUV = 25, TP_WM = 27, TP_NM = 36;
constexpr int SPH_PARAMS = 45;

// cube-sphere warp constant: the JAX kernel sees f32(0.87^2) and
// f32(1 + 0.87^2), each rounded once from the double
constexpr double C_SQR_D = 0.87 * 0.87;

// material buffer (ops/kernels.py pack_shade_spec): a 16-float header, then
// one 16-float record per light
constexpr int SH_INV_MAX = 0, SH_ONE_M = 1, SH_METALLIC = 2, SH_F0 = 3, SH_A2 = 4,
              SH_A2M1 = 5, SH_TWO_ROUGH = 6, SH_N_LIGHTS = 7, SH_EMISSIVE = 8,
              SH_AMBIENT = 11, SH_HEADER = 16, LIGHT_STRIDE = 16;
// light record: kind (0 directional, 1 point, 2 spot), direction to the
// light (directional) or position (point, spot), radiance rgb, 1/range^2,
// spot axis, cos(outer), 1 / (cos(inner) - cos(outer))
constexpr int L_KIND = 0, L_VEC = 1, L_RAD = 4, L_INV_R2 = 7, L_AXIS = 8, L_COS_OUTER = 11,
              L_SCALE = 12;

// The material pass's launch arguments (unused by K1 and K2).
struct AlbedoArgs {
  const int* blocks;     // albedo quad of quad id q at blocks + q * stride
  long long stride;      // words between quads of both streams: 4096, 8192 combined
  int channels, bits, fast;
  const float* shade;    // material buffer (K4)
};

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// The in-kernel fragment stage of one vertex (pallas_kernels.py
// _kernel_pbr_shade), in the TPU kernel's op order; the constants come from
// the material buffer, rounded to f32 on the host as the JAX kernel rounds
// its Python constants. hs: the tile's 17x17 heights; col: raw albedo.
__device__ void pbr_shade(const float* __restrict__ sp, const float* hs, int i, int j,
                          float lodf, const float* fs, const float* col, int channels,
                          float px, float py, float pz, float out[4]) {
  // normals from the blended heights, one-sided at the tile edge
  const float spacing = (2.0f * fs[46]) * exp2f(-lodf) * (1.0f / (GV - 1.0f));
  const float hi_u = hs[i * GV + min(j + 1, GV - 1)], lo_u = hs[i * GV + max(j - 1, 0)];
  const float hi_v = hs[min(i + 1, GV - 1) * GV + j], lo_v = hs[max(i - 1, 0) * GV + j];
  const float dh_du = (hi_u - lo_u) / (2.0f * spacing);
  const float dh_dv = (hi_v - lo_v) / (2.0f * spacing);
  const float ninv = 1.0f / fmaxf(sqrtf(dh_du * dh_du + 1.0f + dh_dv * dh_dv), 1e-8f);
  const float nx = -dh_du * ninv, ny = ninv, nz = -dh_dv * ninv;

  const float inv_max = __ldg(sp + SH_INV_MAX), one_m = __ldg(sp + SH_ONE_M);
  const float metallic = __ldg(sp + SH_METALLIC), f0c = __ldg(sp + SH_F0);
  const float a2 = __ldg(sp + SH_A2), a2m1 = __ldg(sp + SH_A2M1);
  const float two_rough = __ldg(sp + SH_TWO_ROUGH);
  float dc[3], f0[3];
  for (int c = 0; c < 3; ++c) {
    const float b = col[c] * inv_max;
    dc[c] = b * one_m;
    f0[c] = f0c + b * metallic;
    out[c] = __ldg(sp + SH_EMISSIVE + c);
  }
  out[3] = channels > 3 ? col[3] * inv_max : 1.0f;

  float vx = fs[39] - px, vy = fs[40] - py, vz = fs[41] - pz;
  const float vinv = 1.0f / fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-8f);
  vx = vx * vinv;
  vy = vy * vinv;
  vz = vz * vinv;
  const float nov = fmaxf(nx * vx + ny * vy + nz * vz, 1e-4f);
  const float f90 = fminf(fmaxf((f0[0] + f0[1] + f0[2]) * 16.5f, 0.0f), 1.0f);
  const float pi_f = 3.14159265358979323846f, inv_pi_f = (float)(1.0 / 3.14159265358979323846);

  const int n_lights = (int)__ldg(sp + SH_N_LIGHTS);
  for (int k = 0; k < n_lights; ++k) {
    const float* L = sp + SH_HEADER + k * LIGHT_STRIDE;
    const int kind = (int)__ldg(L + L_KIND);
    float lx, ly, lz, atten = 1.0f;
    if (kind == 0) {
      lx = __ldg(L + L_VEC);
      ly = __ldg(L + L_VEC + 1);
      lz = __ldg(L + L_VEC + 2);
    } else {
      const float tx = __ldg(L + L_VEC) - px, ty = __ldg(L + L_VEC + 1) - py,
                  tz = __ldg(L + L_VEC + 2) - pz;
      const float d2l = fmaxf(tx * tx + ty * ty + tz * tz, 1e-4f);
      const float dinv = 1.0f / sqrtf(d2l);
      lx = tx * dinv;
      ly = ty * dinv;
      lz = tz * dinv;
      const float q = d2l * __ldg(L + L_INV_R2);
      const float window = fminf(fmaxf(1.0f - q * q, 0.0f), 1.0f);
      atten = window * window / d2l;
      if (kind == 2) {
        const float cos_a = -(lx * __ldg(L + L_AXIS) + ly * __ldg(L + L_AXIS + 1) +
                              lz * __ldg(L + L_AXIS + 2));
        const float s = fminf(
            fmaxf((cos_a - __ldg(L + L_COS_OUTER)) * __ldg(L + L_SCALE), 0.0f), 1.0f);
        atten = atten * (s * s);
      }
    }
    float hx = lx + vx, hy = ly + vy, hz = lz + vz;
    const float hinv = 1.0f / fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-8f);
    hx = hx * hinv;
    hy = hy * hinv;
    hz = hz * hinv;
    const float nol = fminf(fmaxf(nx * lx + ny * ly + nz * lz, 0.0f), 1.0f);
    const float noh = fminf(fmaxf(nx * hx + ny * hy + nz * hz, 0.0f), 1.0f);
    const float loh = fminf(fmaxf(hx * lx + hy * ly + hz * lz, 0.0f), 1.0f);
    const float f = noh * noh * a2m1 + 1.0f;
    const float d_ggx = a2 / fmaxf(pi_f * f * f, 1e-8f);
    const float lambda_v = nol * sqrtf((nov - a2 * nov) * nov + a2);
    const float lambda_l = nov * sqrtf((nol - a2 * nol) * nol + a2);
    const float v_smith = 0.5f / fmaxf(lambda_v + lambda_l, 1e-8f);
    const float om = pow5(1.0f - loh);
    const float fd90 = 0.5f + two_rough * loh * loh;
    const float light_scatter = 1.0f + (fd90 - 1.0f) * pow5(1.0f - nol);
    const float view_scatter = 1.0f + (fd90 - 1.0f) * pow5(1.0f - nov);
    const float fd = light_scatter * view_scatter * inv_pi_f;
    for (int c = 0; c < 3; ++c) {
      const float fresnel = f0[c] + (f90 - f0[c]) * om;
      const float spec = d_ggx * v_smith * fresnel;
      float contrib = (dc[c] * fd + spec) * __ldg(L + L_RAD + c) * nol;
      if (kind != 0) contrib = contrib * atten;
      out[c] = out[c] + contrib;
    }
  }
  for (int c = 0; c < 3; ++c) out[c] = out[c] + dc[c] * __ldg(sp + SH_AMBIENT + c);
}

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

template <bool SPHERICAL, bool ELLIPSOIDAL, bool ALBEDO, bool SHADE>
__global__ void __launch_bounds__(NTHREADS)
mesh_fused_kernel(const int* __restrict__ blocks, long long n_blocks,
                  const int* __restrict__ ids,
                  const float* __restrict__ geom,         // (n, 8)
                  const float* __restrict__ tile_params,  // (n, 4) or (n, 45)
                  const float* __restrict__ fs,           // (48,)
                  const int* __restrict__ hp_steps,       // (n / 64,), spheres only
                  const int* __restrict__ tile_count,     // (1,)
                  int origin_lod, AlbedoArgs alb, float* __restrict__ out) {
  static_assert(!(SPHERICAL && ALBEDO) && (ALBEDO || !SHADE), "planar material only");
  const int out_ch = (SPHERICAL ? 9 : 6) + (ALBEDO ? alb.channels : 0);
  const int out_per_tile = out_ch * GV * GV;
  constexpr int N_PARAMS = SPHERICAL ? SPH_PARAMS : 4;
  const long long stride = ALBEDO ? alb.stride : QUAD_WORDS;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + (size_t)t * out_per_tile;
  if (t >= __ldg(tile_count)) {
    for (int e = tid; e < out_per_tile; e += NTHREADS) o[e] = 0.0f;
    return;
  }

  __shared__ float patch[P][P];  // height texels; then the albedo words' bits
  __shared__ float H[K][K];   // fine half-grid
  __shared__ float X[K][K];   // H smoothed along x; then the shade's heights
  __shared__ float Hs[K][K];  // 1-2-1 smoothed half-grid (coarser data lod)
  __shared__ long long warp_sum[NWARPS];
  __shared__ float s_mean;
  constexpr int NA = ALBEDO ? MAX_CH : 1;
  constexpr int KA = ALBEDO ? K : 1;
  __shared__ float A[NA][KA][KA];  // albedo half-grids, one per channel
  __shared__ unsigned alb_sum[NWARPS][NA];
  __shared__ float alb_mean[NA];

  // ---- 1. fetch the quad: patch rows 0..31 = q[:, 0:64], rows 32..63 =
  // q[:, 64:128]; exact integer sum for the mean ----
  long long q = ids[t];
  q = q < 0 ? 0 : (q >= n_blocks ? n_blocks - 1 : q);
  const int4* src = reinterpret_cast<const int4*>(blocks + q * stride);
  long long acc = 0;
  for (int v = tid; v < QUAD_WORDS / 4; v += NTHREADS) {
    const int4 w = __ldg(src + v);
    int pr, pc;
    quad_to_patch(v, pr, pc);
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
    const Taps tw = halfgrid_taps(p0x, p0y, dp, k, l);
    const int r0 = tw.r0, c0 = tw.c0;
    const float col0 =
        tw.wy0 * (patch[r0][c0] - mean) + tw.wy1 * (patch[r0 + 1][c0] - mean);
    const float col1 =
        tw.wy0 * (patch[r0][c0 + 1] - mean) + tw.wy1 * (patch[r0 + 1][c0 + 1] - mean);
    H[k][l] = (col0 * tw.wx0 + col1 * tw.wx1) + mean;
  }
  __syncthreads();

  // ---- 3. smoothed copy Hs = A H A^T, A = 1-2-1 with duplicated boundary
  // rows (pallas_kernels.py xsmooth / ysmooth) ----
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    X[k][l] = 0.25f * H[k][max(l - 1, 0)] + 0.5f * H[k][l] + 0.25f * H[k][min(l + 1, K - 1)];
  }
  if (ALBEDO) {
    // the albedo quad into the patch buffer (its words' bits, same
    // arrangement), with exact per-channel integer sums for the exact path
    const int4* asrc = reinterpret_cast<const int4*>(alb.blocks + q * stride);
    unsigned csum[MAX_CH] = {0u, 0u, 0u, 0u};
    for (int v = tid; v < QUAD_WORDS / 4; v += NTHREADS) {
      const int4 w = __ldg(asrc + v);
      int pr, pc;
      quad_to_patch(v, pr, pc);
      patch[pr][pc + 0] = __int_as_float(w.x);
      patch[pr][pc + 1] = __int_as_float(w.y);
      patch[pr][pc + 2] = __int_as_float(w.z);
      patch[pr][pc + 3] = __int_as_float(w.w);
      if (!alb.fast) {
        for (int ch = 0; ch < alb.channels; ++ch) {
          const unsigned m = (1u << alb.bits) - 1u, s = alb.bits * ch;
          csum[ch] += (((unsigned)w.x >> s) & m) + (((unsigned)w.y >> s) & m) +
                      (((unsigned)w.z >> s) & m) + (((unsigned)w.w >> s) & m);
        }
      }
    }
    if (!alb.fast) {
      for (int ch = 0; ch < alb.channels; ++ch) {
        unsigned a = csum[ch];
        for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
        if ((tid & 31) == 0) alb_sum[tid >> 5][ch] = a;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < K * K; e += NTHREADS) {
    const int k = e / K, l = e % K;
    Hs[k][l] = 0.25f * X[max(k - 1, 0)][l] + 0.5f * X[k][l] + 0.25f * X[min(k + 1, K - 1)][l];
  }
  if (ALBEDO && !alb.fast && tid < alb.channels) {
    unsigned long long total = 0;
    for (int w = 0; w < NWARPS; ++w) total += alb_sum[w][tid];
    alb_mean[tid] = (float)((double)total / (double)(P * P));
  }
  __syncthreads();

  // ---- 3b. albedo half-grids with the height's tents: exact (mean-centred
  // f32) or fast (bf16 tents, bf16-rounded y sums, no centring) ----
  if (ALBEDO) {
    for (int e = tid; e < alb.channels * K * K; e += NTHREADS) {
      const int ch = e / (K * K), kl = e % (K * K);
      const int k = kl / K, l = kl % K;
      const Taps tw = halfgrid_taps(p0x, p0y, dp, k, l);
      const int r0 = tw.r0, c0 = tw.c0;
      const float t00 = unpack(__float_as_uint(patch[r0][c0]), ch, alb.bits);
      const float t10 = unpack(__float_as_uint(patch[r0 + 1][c0]), ch, alb.bits);
      const float t01 = unpack(__float_as_uint(patch[r0][c0 + 1]), ch, alb.bits);
      const float t11 = unpack(__float_as_uint(patch[r0 + 1][c0 + 1]), ch, alb.bits);
      if (alb.fast) {
        const float by0 = bf16_rn(tw.wy0), by1 = bf16_rn(tw.wy1);
        const float row0 = bf16_rn(by0 * t00 + by1 * t10);
        const float row1 = bf16_rn(by0 * t01 + by1 * t11);
        A[ch][k][l] = row0 * bf16_rn(tw.wx0) + row1 * bf16_rn(tw.wx1);
      } else {
        const float m = alb_mean[ch];
        const float col0 = tw.wy0 * (t00 - m) + tw.wy1 * (t10 - m);
        const float col1 = tw.wy0 * (t01 - m) + tw.wy1 * (t11 - m);
        A[ch][k][l] = (col0 * tw.wx0 + col1 * tw.wx1) + m;
      }
    }
    __syncthreads();
  }

  // ---- 4. per vertex (i = row / v, j = column / u); the shade needs every
  // thread at its barrier, so there threads past the last vertex repeat it
  // without writing ----
  const bool active = tid < NVERT;
  if (!SHADE && !active) return;
  const int vid = active ? tid : NVERT - 1;
  const int i = vid / GV, j = vid % GV;
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

  if (ALBEDO) {
    // albedo channels at the same morphed uv through the same window
    // weights (raw texel values; the caller normalises)
    float col[MAX_CH];
    for (int ch = 0; ch < alb.channels; ++ch) {
      float acc_c = 0.0f;
      for (int b = 0; b < 3; ++b) {
        const int r = tap(i, b);
        for (int a = 0; a < 3; ++a) {
          const float w = wyb[b] * wxa[a];
          acc_c = acc_c + w * A[ch][r][tap(j, a)];
        }
      }
      col[ch] = acc_c;
    }
    if (SHADE) {
      float* hs = &X[0][0];
      if (active) hs[vtx] = height;
      __syncthreads();
      float shaded[4];
      pbr_shade(alb.shade, hs, i, j, lodf, fs, col, alb.channels, px, py, pz, shaded);
      for (int ch = 0; ch < alb.channels; ++ch) col[ch] = shaded[ch];
    }
    if (active) {
      for (int ch = 0; ch < alb.channels; ++ch)
        o[(6 + ch) * GV * GV + vtx] = col[ch] * valid * live;
    }
  }
  if (!active) return;

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
  mesh_fused_kernel<false, false, false, false><<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
      (const float*)tile_params, (const float*)fs, nullptr, (const int*)tile_count, 0,
      AlbedoArgs{}, (float*)out);
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
    mesh_fused_kernel<true, true, false, false><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, (const int*)hp_steps,
        (const int*)tile_count, origin_lod, AlbedoArgs{}, (float*)out);
  } else {
    mesh_fused_kernel<true, false, false, false><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, (const int*)hp_steps,
        (const int*)tile_count, origin_lod, AlbedoArgs{}, (float*)out);
  }
  return (int)cudaGetLastError();
}

// K3 (shade == nullptr) and K4. Combined: one (N, 64, 128) array, heights
// in rows 0:32 and the packed albedo in rows 32:64 of each quad.
extern "C" int mesh_fused_material_launch(const void* blocks, long long n_blocks,
                                          const void* ids, const void* geom,
                                          const void* tile_params, const void* fs,
                                          const void* tile_count, const void* albedo,
                                          int channels, int bits, int fast, int combined,
                                          const void* shade, void* out, int n_tiles,
                                          void* stream) {
  if (n_tiles <= 0) return 0;
  if (channels < 1 || channels > MAX_CH || (bits != 8 && bits != 16) ||
      channels * bits > 32 || (fast && bits != 8))
    return (int)cudaErrorInvalidValue;
  AlbedoArgs alb;
  alb.stride = combined ? 2 * QUAD_WORDS : QUAD_WORDS;
  alb.blocks = combined ? (const int*)blocks + QUAD_WORDS : (const int*)albedo;
  alb.channels = channels;
  alb.bits = bits;
  alb.fast = fast;
  alb.shade = (const float*)shade;
  const cudaStream_t s = (cudaStream_t)stream;
  if (shade) {
    mesh_fused_kernel<false, false, true, true><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, nullptr, (const int*)tile_count, 0, alb,
        (float*)out);
  } else {
    mesh_fused_kernel<false, false, true, false><<<n_tiles, NTHREADS, 0, s>>>(
        (const int*)blocks, n_blocks, (const int*)ids, (const float*)geom,
        (const float*)tile_params, (const float*)fs, nullptr, (const int*)tile_count, 0, alb,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
