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
//   (U_MAX / LOOKAHEAD) because a TPU DMA costs ~100 ns to start. What
//   bounds the kernel on this card is the bytes it must move (the output
//   and the frame's few hundred unique quads, a few MB that stay in the 50
//   MB L2); the per-tile arithmetic (a 33x33 two-tap resample, two 1-2-1
//   passes, 289 vertices, and for spheres two cube-sphere evaluations and
//   two Taylor chains per vertex) is small. What keeps it off that bound is
//   what it spends per tile, so every instance walks runs of tiles:
// * A block walks a run of consecutive tiles in the plan's order, which
//   sorts the tiles by quad id (some 15 tiles a quad at the bench frame),
//   and keeps the quad it holds, raw (32, 128) in shared memory, with its
//   exact integer mean while the ids repeat -- what the TPU kernel's ring of
//   unique quads (uq / slots) kept out of memory. Any order of ids is right;
//   a sorted one is fast. The live tiles are split evenly over a grid of
//   `waves` (a launch constant of ops/kernels.py) times the blocks the card
//   holds at once, so no block waits for a tail wave.
// * The next tile's quad, when its id differs, is copied with cp.async
//   behind the current tile. K1 and K2 hold the quad as a float patch in
//   natural texel order, unpacked once per quad with its exact integer
//   mean, beside a raw buffer that takes the next quad's copy from the top
//   of the tile on. The material instances (K3 / K3s / K4) hold the raw
//   height and albedo quads (packed channels are unpacked per point) and
//   start both copies once the tile's half-grids are built, behind the
//   smoothing, vertex and shade phases. The first quad of a run is in
//   flight while the block zeroes its share of the dead tiles.
// * The tent resample evaluates a tent's two non-zero taps: each half-grid
//   point is a 2x2 bilinear of the mean-centred patch in natural order, the
//   value of the TPU kernel's dense MXU product in its evens-first order,
//   without the 64-wide contractions. The 1-2-1 smoothed grid is formed
//   straight from H, with no stored x pass: K1 / K2 give each thread a
//   strip of four points down one column (the column's x taps formed once,
//   the x-smoothed rows around the strip once), the material instances
//   recompute each point's three x taps; the values are a stored pass's. A
//   tile with a held quad crosses three barriers (four with the shade).
// * On spheres the unmorphed cube-sphere warp terms (pxs per column, pys
//   per row) are a table of 2 x 17 per tile, built beside the smoothing;
//   the morphed evaluation stays per vertex. K1 / K2 stage the tile's
//   parameters (4 or 45 floats) and its constants (2^-lod and the two
//   frame reciprocals of the morph and blend ranges, one thread each) in
//   shared memory behind the same barrier.
// * Tiles at index >= tile_count (read from device memory) are zeros,
//   written with 16-byte stores and no fetch, as the TPU kernel zeroes its
//   dead steps. The sphere's high-precision flag stays per 64-tile step, as
//   in the TPU kernel: a vertex takes the Taylor near field where its
//   world-frame distance is inside the threshold AND its step (tile index
//   >> 6) is flagged 2, even if its own tile's bound is "far"; a run may
//   start anywhere in a step.
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
// The material variants of the same TPU kernel (mesh_material_kernel):
//
// * K3, albedo (mesh_fused with albedo_channels / albedo_bits / albedo_fast /
//   albedo_combined), planar and spherical (K3s): per tile a second 16 KB
//   quad of packed texels (C channels of B bits in one int32 word, channel
//   c in bits [cB, (c+1)B)), from its own block array or from rows 32:64
//   of a combined (N, 64, 128) array, resampled with the height's tents and
//   read at the morphed uv through the height's window weights; C rows of
//   raw texel values x valid x live follow the mesh rows: (n_tiles, 6 + C,
//   17, 17) for a planar terrain, (n_tiles, 9 + C, 17, 17) for a sphere (in
//   the Taylor near field the normal is the unmorphed one while the albedo
//   is still read at the morphed uv, as in the TPU kernel). The exact path
//   is K1's mean-centred f32 resample per channel; the fast path (B = 8) is
//   the TPU kernel's bf16 MXU path emulated on the CUDA cores
//   (tile_quad.cuh halfgrid_channels).
// * K4, shaded (mesh_fused with shade=, _kernel_pbr_shade), planar only (its
//   normals are a planar central difference): K3 plus the fragment stage
//   on the per-vertex values already in registers -- central-difference
//   normals over the tile's heights (one-sided at the tile edge, as the TPU
//   kernel's clamped lane shift), Filament GGX + Smith + Schlick + Burley
//   for any number of directional / point / spot lights, emissive and
//   ambient. The material is a small f32 buffer (ops/kernels.py
//   pack_shade_spec), read per launch: no rebuild per material and no cap
//   on the light count.
//
// K1 / K2 (mesh_fused_kernel) and the material instances
// (mesh_material_kernel) share the vertex stage and the per-point op order,
// so the material instances' mesh rows are bit-equal to K1's (K2's on a
// sphere), and a block's run length changes no bit. K1 / K2 take ~41 KB of
// static shared memory (the next quad raw, the held one as floats, H, Hs),
// four blocks per SM for K1 (48 registers) and three for K2 (64); the
// material instances ~59 KB of dynamic shared memory (a height and an
// albedo quad, H, Hs, four albedo half-grids, the shade's heights), three
// blocks per SM.

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

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// The in-kernel fragment stage of one vertex (pallas_kernels.py
// _kernel_pbr_shade), in the TPU kernel's op order; the constants come from
// the material buffer, rounded to f32 on the host as the JAX kernel rounds
// its Python constants. hs: the tile's 17x17 heights; col: raw albedo.
__device__ __forceinline__ void pbr_shade(const float* __restrict__ sp, const float* hs, int i,
                                          int j, float lodf, const float* fs, const float* col,
                                          int channels, float px, float py, float pz,
                                          float out[4]) {
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

// One cube-sphere warp term of far_geom (pallas_kernels.py): pxs of tile
// coordinate u with origin = the tile's x, or pys of v with its y, at
// inv_count = 2^-lod.
__device__ __forceinline__ float warp_term(float uv, float origin, float inv_count) {
  const float c = (float)C_SQR_D;
  const float one_c = (float)(1.0 + C_SQR_D);
  const float wp = 2.0f * ((origin + uv) * inv_count) - 1.0f;
  return wp * rsqrt_rn(one_c - c * wp * wp);
}

// Cube-sphere world position + unit world normal from the warp terms (pxs,
// pys) of a tile uv (pallas_kernels.py far_geom): the closed-form cube-point
// norm rsqrt(1 + pxs^2 + pys^2), the per-tile side-composed WM rows plus the
// translation fs[3, 7, 11]; normal = pre-translation point / R (fs[42]) for
// a sphere, normalize(NM rows . (pxs, pys, 1)) for an ellipsoid.
template <bool ELLIPSOIDAL>
__device__ __forceinline__ void far_geom(float pxs, float pys, const float* tp,
                                         const float* fs, Vec3& w, Vec3& n) {
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

// What the vertex stage leaves for the writes, the albedo and the shade.
struct Vertex {
  float height, px, py, pz, mu, mv;
  Vec3 n;                // the unit world normal (spheres)
  float wyb[3], wxa[3];  // the 3x3 window's weights at the morphed uv
};

// The vertex stage's per-tile constants, each one correctly rounded op:
// 2^-lod (tp[1]), 1 / morph_range (fs[19]), 1 / blend_range (fs[21]).
constexpr int TILE_CONSTS = 3;

__device__ __forceinline__ float tile_const(int c, const float* tp, const float* fs) {
  return c == 0 ? exp2f(-tp[1]) : 1.0f / fs[c == 1 ? 19 : 21];
}

// Phase 4 of every mesh kernel for vertex (i = row / v, j = column / u) of
// tile t: view distance (planar, or the cube sphere's with the Taylor near
// field on high-precision steps), CDLOD morph, the 3x3 window of the fine
// and smoothed half-grids H and Hs (33x33, natural order), per-vertex
// blend, height, world position (and normal). warp: the tile's unmorphed
// warp terms on a sphere, pxs of column j at warp[j], pys of row i at
// warp[GV + i]; consts: the tile's TILE_CONSTS.
template <bool SPHERICAL, bool ELLIPSOIDAL>
__device__ __forceinline__ Vertex vertex_stage(int t, int i, int j, const float* tp,
                                               const float* __restrict__ fs,
                                               const int* __restrict__ hp_steps,
                                               int origin_lod, float valid, const float* H,
                                               const float* Hs, const float* warp,
                                               const float* consts) {
  Vertex r;
  const float live = tp[0], lodf = tp[1], xf = tp[2], yf = tp[3];
  const float inv16 = 1.0f / (GV - 1.0f);
  const float u = (float)j * inv16;
  const float v = (float)i * inv16;
  const float inv_count = consts[0];

  float d2;
  bool near = false;
  Vec3 w0 = {}, n0 = {};
  Anchor anchor = {};
  if (SPHERICAL) {
    // world-frame view distance^2 at the approximate height fs[29] (view
    // fs[39..41]); on high-precision steps the Taylor distance replaces it
    // inside the threshold (fs[45] = threshold^2)
    far_geom<ELLIPSOIDAL>(warp[j], warp[GV + i], tp, fs, w0, n0);
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
  float mr = fminf(fmaxf((lodf + fs[19] - target_lod) * consts[1], 0.0f), 1.0f);
  mr = (lodf == 0.0f ? 0.0f : mr) * fs[24];
  const float even_u = (float)(j & ~1) * inv16;
  const float even_v = (float)(i & ~1) * inv16;
  const float mu = u + (even_u - u) * mr;
  const float mv = v + (even_v - v) * mr;

  // 3x3 tent window at the morphed uv, fine and smoothed slabs
  const float lxw = mu * (2.0f * (GV - 1.0f)) - (float)max(2 * j - 2, 0);
  const float lyw = mv * (2.0f * (GV - 1.0f)) - (float)max(2 * i - 2, 0);
  for (int b = 0; b < 3; ++b) {
    r.wyb[b] = tent(lyw, (float)b);
    r.wxa[b] = tent(lxw, (float)b);
  }
  float h_fine = 0.0f, h_smooth = 0.0f;
  for (int b = 0; b < 3; ++b) {
    const int row = tap(i, b);
    for (int a = 0; a < 3; ++a) {
      const int c = tap(j, a);
      const float w = r.wyb[b] * r.wxa[a];
      h_fine = h_fine + w * H[row * K + c];
      h_smooth = h_smooth + w * Hs[row * K + c];
    }
  }

  // per-vertex blend crossfade (fs 44 log2(blend_distance), 26 lod cap,
  // 21 blend_range, 25 blend on), height (fs 22 min, 23 range / max_value)
  const float btarget = fminf(fs[44] - log2_dist, fs[26]);
  const float blod = (float)(int)fmaxf(btarget, 0.0f);
  const float bratio =
      (blod == 0.0f ? 0.0f
                    : fminf(fmaxf((blod + fs[21] - btarget) * consts[2], 0.0f), 1.0f)) *
      fs[25];
  const float h_norm = (h_fine + (h_smooth - h_fine) * bratio) * valid;
  const float height = (fs[22] + fs[23] * h_norm) * live;

  if (SPHERICAL) {
    // world position at the morphed uv; in the near field the Taylor
    // relative position (view + rel) replaces it and the unmorphed normal
    // is kept
    Vec3 wm, nm;
    far_geom<ELLIPSOIDAL>(warp_term(mu, xf, inv_count), warp_term(mv, yf, inv_count), tp,
                          fs, wm, nm);
    if (near) {
      const Vec3 rm = taylor_rel(mu, mv, anchor, tp, fs);
      wm.x = fs[39] + rm.x;
      wm.y = fs[40] + rm.y;
      wm.z = fs[41] + rm.z;
      nm = n0;
    }
    r.px = wm.x + height * nm.x;
    r.py = wm.y + height * nm.y;
    r.pz = wm.z + height * nm.z;
    r.n = nm;
  } else {
    // morphed world position + height along the up normal (fs 15..17)
    const float mlx = (xf + mu) * inv_count - 0.5f;
    const float mlz = (yf + mv) * inv_count - 0.5f;
    r.px = fs[0] * mlx + fs[2] * mlz + fs[3] + height * fs[15];
    r.py = fs[4] * mlx + fs[6] * mlz + fs[7] + height * fs[16];
    r.pz = fs[8] * mlx + fs[10] * mlz + fs[11] + height * fs[17];
  }
  r.height = height;
  r.mu = mu;
  r.mv = mv;
  return r;
}

// The mesh rows of vertex vtx: [h, px, py, pz, u, v] (x live), and on a
// sphere the normal rows 6..8.
template <bool SPHERICAL>
__device__ __forceinline__ void write_mesh_rows(float* o, int vtx, const Vertex& v,
                                                float live) {
  if (SPHERICAL) {
    o[6 * NVERT + vtx] = v.n.x * live;
    o[7 * NVERT + vtx] = v.n.y * live;
    o[8 * NVERT + vtx] = v.n.z * live;
  }
  o[0 * NVERT + vtx] = v.height;
  o[1 * NVERT + vtx] = v.px * live;
  o[2 * NVERT + vtx] = v.py * live;
  o[3 * NVERT + vtx] = v.pz * live;
  o[4 * NVERT + vtx] = v.mu * live;
  o[5 * NVERT + vtx] = v.mv * live;
}

// The K1 / K2 half-grid passes give each thread a strip (tile_quad.cuh):
// the column's x taps (H) or the x-smoothed rows around the strip (Hs) are
// formed once for the strip.

// K1 / K2's shared memory.
struct MeshShared {
  alignas(16) int raw[QUAD_WORDS];  // the next quad, raw (32, 128): the cp.async target
  float patch[P][P];    // the held quad, natural texel order
  float H[K][K];        // fine half-grid
  float Hs[K][K];       // 1-2-1 smoothed half-grid (coarser data lod)
  float warp[2 * GV];   // spheres: the unmorphed pxs per column, pys per row
  float tp[SPH_PARAMS];  // the tile's parameters
  float consts[TILE_CONSTS];
  long long warp_sum[NWARPS];
  float mean;
};

// The tile's unmorphed cube-sphere warp terms into warp[0, 2 GV): pxs of
// its columns, then pys of its rows, one per thread of the block's last 2 GV
// (the same ops as far_geom's unmorphed evaluation per vertex).
__device__ __forceinline__ void warp_table(int tid, const float* tp, float* warp) {
  const int w = tid - (NTHREADS - 2 * GV);
  if (w < 0) return;
  const int a = w < GV ? 0 : 1;  // 0: column (x, u); 1: row (y, v)
  warp[w] = warp_term((float)(w - a * GV) * (1.0f / (GV - 1.0f)), tp[2 + a], exp2f(-tp[1]));
}

// K1 (planar) and K2 (spherical): runs of tiles per block, built for four
// blocks per SM (K1, 48 registers) or three (K2, 64). The held quad is a
// float patch, its exact mean taken once; the next tile's quad, when its id
// differs, is copied raw behind the whole current tile and unpacked at the
// top of the next.
template <bool SPHERICAL, bool ELLIPSOIDAL>
__global__ void __launch_bounds__(NTHREADS, SPHERICAL ? 3 : 4)
mesh_fused_kernel(const int* __restrict__ blocks, long long n_blocks,
                  const int* __restrict__ ids,
                  const float* __restrict__ geom,         // (n, 8)
                  const float* __restrict__ tile_params,  // (n, 4) or (n, 45)
                  const float* __restrict__ fs,           // (48,)
                  const int* __restrict__ hp_steps,       // (n / 64,), spheres only
                  const int* __restrict__ tile_count,     // (1,)
                  int n_tiles, int origin_lod, float* __restrict__ out) {
  constexpr int OUT_CH = SPHERICAL ? 9 : 6;
  constexpr int N_PARAMS = SPHERICAL ? SPH_PARAMS : 4;
  __shared__ MeshShared s;
  const TileRun run = tile_run(n_tiles, __ldg(tile_count));
  long long q = 0;
  if (run.t0 < run.t1) {
    q = quad_id(ids, run.t0, n_blocks);
    fetch_quad_async(s.raw, blocks + q * QUAD_WORDS);
  }
  // the dead tiles' zeros go out while the first quad lands
  zero_fill(out + (size_t)run.d0 * OUT_CH * NVERT, out + (size_t)run.d1 * OUT_CH * NVERT);
  if (run.t0 == run.t1) return;
  cp_async_wait();
  __syncthreads();
  bool fetched = true;  // s.raw holds quad q: unpack it and take its mean
  float mean = 0.0f;
  for (int t = run.t0; t < run.t1; ++t) {
    const int tid = opaque((int)threadIdx.x);
    const float* fs_t = opaque(fs);
    if (fetched) {
      mean = block_mean(unpack_patch(s.raw, s.patch), s.warp_sum, &s.mean);
      fetched = false;
    }
    // s.raw is free: the next tile's quad, if another, lands behind this tile
    const long long next = t + 1 < run.t1 ? quad_id(ids, t + 1, n_blocks) : q;
    if (next != q) fetch_quad_async(s.raw, blocks + next * QUAD_WORDS);

    // ---- 1. tent resample of the mean-centred patch at the 33x33
    // half-grid positions clip(p0 + k * dp, 0, 63): H = Wy (P - c) Wx^T + c
    // ----
    const float* g = geom + (size_t)t * 8;
    const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3];
    const int l = tid % K, k0 = tid / K * STRIP;
    if (tid < K * STRIPS) {
      const AxisTaps x = axis_taps(p0x, dp, l);
#pragma unroll
      for (int d = 0; d < STRIP; ++d) {
        const int k = k0 + d;
        if (k >= K) break;
        const AxisTaps y = axis_taps(p0y, dp, k);
        s.H[k][l] =
            centred_bilinear(s.patch, mean, {y.i0, x.i0, y.w0, y.w1, x.w0, x.w1}) + mean;
      }
    }
    __syncthreads();

    // ---- 2. smoothed copy Hs = A H A^T, A = 1-2-1 with duplicated boundary
    // rows (pallas_kernels.py xsmooth / ysmooth): the strip's x-smoothed
    // rows, then the y taps over them; beside it the tile's parameters and
    // constants go to shared memory and, on a sphere, the last 2 GV threads
    // build the tile's warp table ----
    const float* tp = tile_params + (size_t)t * N_PARAMS;
    if (tid < K * STRIPS) {
      const int lm = max(l - 1, 0), lp = min(l + 1, K - 1);
      float x[STRIP + 2];
#pragma unroll
      for (int d = 0; d < STRIP + 2; ++d) {
        const int r = min(max(k0 - 1 + d, 0), K - 1);
        x[d] = smooth3(s.H[r][lm], s.H[r][l], s.H[r][lp]);
      }
#pragma unroll
      for (int d = 0; d < STRIP; ++d) {
        if (k0 + d >= K) break;
        s.Hs[k0 + d][l] = smooth3(x[d], x[d + 1], x[d + 2]);
      }
    }
    const int c = tid - (NTHREADS - 2 * GV - N_PARAMS);
    if (c >= 0 && c < N_PARAMS) s.tp[c] = tp[c];
    if (c < 0 && c >= -TILE_CONSTS) s.consts[-1 - c] = tile_const(-1 - c, tp, fs_t);
    if (SPHERICAL) warp_table(tid, tp, s.warp);
    __syncthreads();
    tp = s.tp;

    // ---- 3. per vertex ----
    if (tid < NVERT) {
      const Vertex v = vertex_stage<SPHERICAL, ELLIPSOIDAL>(
          t, tid / GV, tid % GV, tp, fs_t, hp_steps, origin_lod, valid, &s.H[0][0],
          &s.Hs[0][0], s.warp, s.consts);
      write_mesh_rows<SPHERICAL>(out + (size_t)t * OUT_CH * NVERT, tid, v, tp[0]);
    }
    if (next != q) {
      cp_async_wait();
      q = next;
      fetched = true;
    }
    __syncthreads();  // H, Hs and the patch are read; the next quad has landed
  }
}

// The material kernel's shared memory (dynamic: over 48 KB).
struct MaterialShared {
  int hq[QUAD_WORDS];      // the held height quad, raw (32, 128)
  int aq[QUAD_WORDS];      // the held albedo quad, raw
  float H[K][K];           // fine half-grid
  float Hs[K][K];          // 1-2-1 smoothed half-grid (coarser data lod)
  float A[MAX_CH][K][K];   // albedo half-grids, one per channel
  float hs[NVERT];         // the tile's vertex heights (the shade's normals)
  float warp[2 * GV];      // spheres: the unmorphed pxs per column, pys per row
  long long warp_sum[NWARPS][MAX_SUMS];
  float mean[MAX_SUMS];    // the height's, then the albedo channels' (exact path)
};

// K3 (planar and spherical) and K4 (SHADE, planar): runs of tiles per block,
// three blocks per SM (the shared memory allows three; registers capped to
// match).
constexpr int MATERIAL_MIN_BLOCKS = 3;

template <bool SPHERICAL, bool ELLIPSOIDAL, bool SHADE>
__global__ void __launch_bounds__(NTHREADS, MATERIAL_MIN_BLOCKS)
mesh_material_kernel(const int* __restrict__ blocks, long long n_blocks,
                     const int* __restrict__ ids,
                     const float* __restrict__ geom,         // (n, 8)
                     const float* __restrict__ tile_params,  // (n, 4) or (n, 45)
                     const float* __restrict__ fs,           // (48,)
                     const int* __restrict__ hp_steps,       // (n / 64,), spheres only
                     const int* __restrict__ tile_count,     // (1,)
                     int n_tiles, int origin_lod, AlbedoArgs alb, float* __restrict__ out) {
  static_assert(!(SPHERICAL && SHADE), "the shade is planar");
  constexpr int BASE_CH = SPHERICAL ? 9 : 6;  // mesh rows before the albedo's
  constexpr int N_PARAMS = SPHERICAL ? SPH_PARAMS : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  MaterialShared& s = *reinterpret_cast<MaterialShared*>(smem);
  const int out_per_tile = (BASE_CH + alb.channels) * NVERT;
  const TileRun run = tile_run(n_tiles, __ldg(tile_count));
  // heights and albedo of quad q: blocks + q * stride and alb.blocks + q *
  // stride (rows 0:32 and 32:64 of a combined array)
  long long q = 0;
  if (run.t0 < run.t1) {
    q = quad_id(ids, run.t0, n_blocks);
    fetch_quad_async(s.hq, blocks + q * alb.stride);
    fetch_quad_async(s.aq, alb.blocks + q * alb.stride);
  }
  // the dead tiles' zeros go out while the first quads land
  zero_fill(out + (size_t)run.d0 * out_per_tile, out + (size_t)run.d1 * out_per_tile);
  if (run.t0 == run.t1) return;
  cp_async_wait();
  __syncthreads();
  bool fetched = true;  // the quads in shared memory are new: take their means
  for (int t = run.t0; t < run.t1; ++t) {
    const int tid = opaque((int)threadIdx.x);
    const float* fs_t = opaque(fs);
    if (fetched) {
      // the height's exact integer mean; the albedo channels' on the exact path
      long long acc[MAX_SUMS] = {0, 0, 0, 0, 0};
      quad_sums(s.hq, 1, 0, acc);
      if (!alb.fast) quad_sums(s.aq, alb.channels, alb.bits, acc + 1);
      block_means(acc, alb.fast ? 1 : 1 + alb.channels, s.warp_sum, s.mean);
      fetched = false;
    }

    // ---- 1. the half-grids at the positions clip(p0 + k * dp, 0, 63):
    // H = Wy (P - c) Wx^T + c and every albedo channel, one pass over the
    // points ----
    const float* g = geom + (size_t)t * 8;
    const float p0x = g[0], p0y = g[1], dp = g[2], valid = g[3];
    for (int e = tid; e < K * K; e += NTHREADS) {
      const int k = e / K, l = e % K;
      const Taps tw = halfgrid_taps(p0x, p0y, dp, k, l);
      halfgrid_channels(quad_corners(s.hq, tw), tw, 1, 0, false, s.mean, &s.H[k][l]);
      halfgrid_channels(quad_corners(s.aq, tw), tw, alb.channels, alb.bits, alb.fast,
                        s.mean + 1, &s.A[0][k][l]);
    }
    __syncthreads();

    // the quads are free: start the next tile's, if they are others
    bool next_quads = false;
    if (t + 1 < run.t1) {
      const long long next = quad_id(ids, t + 1, n_blocks);
      if (next != q) {
        q = next;
        fetch_quad_async(s.hq, blocks + q * alb.stride);
        fetch_quad_async(s.aq, alb.blocks + q * alb.stride);
        next_quads = true;
      }
    }

    // ---- 2. smoothed copy Hs = A H A^T (A = 1-2-1 with duplicated
    // boundary rows), each point's three x taps as K1's x-smoothed rows
    // hold them; on a sphere the tile's warp table ----
    for (int e = tid; e < K * K; e += NTHREADS) {
      const int k = e / K, l = e % K;
      const int lm = max(l - 1, 0), lp = min(l + 1, K - 1);
      float x[3];
      for (int d = 0; d < 3; ++d) {
        const int r = min(max(k - 1 + d, 0), K - 1);
        x[d] = smooth3(s.H[r][lm], s.H[r][l], s.H[r][lp]);
      }
      s.Hs[k][l] = smooth3(x[0], x[1], x[2]);
    }
    const float* tp = tile_params + (size_t)t * N_PARAMS;
    if (SPHERICAL) warp_table(tid, tp, s.warp);
    __syncthreads();

    // ---- 3. per vertex; the albedo channels at the morphed uv through the
    // height's window weights (raw texel values; the caller normalises),
    // then the shade over the tile's heights ----
    const bool active = tid < NVERT;
    const int i = tid / GV, j = tid % GV;
    Vertex v;
    float col[MAX_CH];
    if (active) {
      const float consts[TILE_CONSTS] = {tile_const(0, tp, fs_t), tile_const(1, tp, fs_t),
                                         tile_const(2, tp, fs_t)};
      v = vertex_stage<SPHERICAL, ELLIPSOIDAL>(t, i, j, tp, fs_t, hp_steps, origin_lod, valid,
                                               &s.H[0][0], &s.Hs[0][0], s.warp, consts);
#pragma unroll
      for (int ch = 0; ch < MAX_CH; ++ch) {
        if (ch >= alb.channels) break;
        float acc_c = 0.0f;
        for (int b = 0; b < 3; ++b) {
          const int r = tap(i, b);
          for (int a = 0; a < 3; ++a) {
            const float w = v.wyb[b] * v.wxa[a];
            acc_c = acc_c + w * s.A[ch][r][tap(j, a)];
          }
        }
        col[ch] = acc_c;
      }
      if (SHADE) s.hs[tid] = v.height;
    }
    if (SHADE) {
      __syncthreads();
      if (active) {
        float shaded[4];
        pbr_shade(opaque(alb.shade), s.hs, i, j, tp[1], fs_t, col, alb.channels, v.px, v.py,
                  v.pz, shaded);
#pragma unroll
        for (int ch = 0; ch < MAX_CH; ++ch)
          if (ch < alb.channels) col[ch] = shaded[ch];
      }
    }
    if (active) {
      float* o = out + (size_t)t * out_per_tile;
      const float live = tp[0];
      write_mesh_rows<SPHERICAL>(o, tid, v, live);
#pragma unroll
      for (int ch = 0; ch < MAX_CH; ++ch)
        if (ch < alb.channels) o[(BASE_CH + ch) * NVERT + tid] = col[ch] * valid * live;
    }
    if (next_quads) {
      cp_async_wait();
      fetched = true;
    }
    __syncthreads();  // H, Hs, A and hs are read; new quads have landed
  }
}

constexpr int MATERIAL_SMEM = (int)sizeof(MaterialShared);

const KernelInstance INSTANCES[] = {
    {"mesh_fused_planar", (const void*)mesh_fused_kernel<false, false>, 0},
    {"mesh_fused_spherical (sphere)", (const void*)mesh_fused_kernel<true, false>, 0},
    {"mesh_fused_spherical (ellipsoid)", (const void*)mesh_fused_kernel<true, true>, 0},
    {"mesh_fused_albedo", (const void*)mesh_material_kernel<false, false, false>,
     MATERIAL_SMEM},
    {"mesh_fused_shaded", (const void*)mesh_material_kernel<false, false, true>, MATERIAL_SMEM},
    {"mesh_fused_spherical_albedo (sphere)",
     (const void*)mesh_material_kernel<true, false, false>, MATERIAL_SMEM},
    {"mesh_fused_spherical_albedo (ellipsoid)",
     (const void*)mesh_material_kernel<true, true, false>, MATERIAL_SMEM},
};

// Check the albedo's launch arguments and pack them. Combined: one (N, 64,
// 128) array, heights in rows 0:32 and the packed albedo in rows 32:64 of
// each quad.
bool albedo_args(const void* blocks, const void* albedo, int channels, int bits, int fast,
                 int combined, const void* shade, AlbedoArgs& alb) {
  if (channels < 1 || channels > MAX_CH || (bits != 8 && bits != 16) ||
      channels * bits > 32 || (fast && bits != 8))
    return false;
  alb.stride = combined ? 2 * QUAD_WORDS : QUAD_WORDS;
  alb.blocks = combined ? (const int*)blocks + QUAD_WORDS : (const int*)albedo;
  alb.channels = channels;
  alb.bits = bits;
  alb.fast = fast;
  alb.shade = (const float*)shade;
  return true;
}

// Launch `kernel` over n_tiles tiles on `waves` times the blocks the card
// holds at once (`resident`: the instance's run_grid cache) with `smem`
// bytes of dynamic shared memory; returns cudaGetLastError() of the launch.
template <class... Params, class... Args>
int launch_runs(void (*kernel)(Params...), int smem, int* resident, int n_tiles, int waves,
                cudaStream_t stream, Args... args) {
  if (waves < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = run_grid((const void*)kernel, smem, waves, n_tiles, resident);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, NTHREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// K1 / K2 over n_tiles tiles.
template <bool SPHERICAL, bool ELLIPSOIDAL>
int launch_mesh(const void* blocks, long long n_blocks, const void* ids, const void* geom,
                const void* tile_params, const void* fs, const void* hp_steps,
                const void* tile_count, int n_tiles, int waves, int origin_lod, void* out,
                cudaStream_t stream) {
  static int resident[64] = {};
  return launch_runs(mesh_fused_kernel<SPHERICAL, ELLIPSOIDAL>, 0, resident, n_tiles, waves,
                     stream, (const int*)blocks, n_blocks, (const int*)ids,
                     (const float*)geom, (const float*)tile_params, (const float*)fs,
                     (const int*)hp_steps, (const int*)tile_count, n_tiles, origin_lod,
                     (float*)out);
}

// One material kernel instance over n_tiles tiles.
template <bool SPHERICAL, bool ELLIPSOIDAL, bool SHADE>
int launch_material(const void* blocks, long long n_blocks, const void* ids, const void* geom,
                    const void* tile_params, const void* fs, const void* hp_steps,
                    const void* tile_count, int n_tiles, int waves, int origin_lod,
                    const AlbedoArgs& alb, void* out, cudaStream_t stream) {
  static int resident[64] = {};
  return launch_runs(mesh_material_kernel<SPHERICAL, ELLIPSOIDAL, SHADE>, MATERIAL_SMEM,
                     resident, n_tiles, waves, stream, (const int*)blocks, n_blocks,
                     (const int*)ids, (const float*)geom, (const float*)tile_params,
                     (const float*)fs, (const int*)hp_steps, (const int*)tile_count, n_tiles,
                     origin_lod, alb, (float*)out);
}

}  // namespace

int mesh_fused_instances(const KernelInstance** table) {
  *table = INSTANCES;
  return (int)(sizeof(INSTANCES) / sizeof(INSTANCES[0]));
}

// Launch on the caller's stream, on `waves` times the blocks the card holds
// at once. Each returns cudaGetLastError() of the launch (0 on success); the
// kernels allocate nothing and do not synchronise.
extern "C" int mesh_fused_planar_launch(const void* blocks, long long n_blocks,
                                        const void* ids, const void* geom,
                                        const void* tile_params, const void* fs,
                                        const void* tile_count, void* out, int n_tiles,
                                        int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  return launch_mesh<false, false>(blocks, n_blocks, ids, geom, tile_params, fs, nullptr,
                                   tile_count, n_tiles, waves, 0, out, (cudaStream_t)stream);
}

extern "C" int mesh_fused_spherical_launch(const void* blocks, long long n_blocks,
                                           const void* ids, const void* geom,
                                           const void* tile_params, const void* fs,
                                           const void* hp_steps, const void* tile_count,
                                           void* out, int n_tiles, int origin_lod,
                                           int ellipsoidal, int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ellipsoidal)
    return launch_mesh<true, true>(blocks, n_blocks, ids, geom, tile_params, fs, hp_steps,
                                   tile_count, n_tiles, waves, origin_lod, out, s);
  return launch_mesh<true, false>(blocks, n_blocks, ids, geom, tile_params, fs, hp_steps,
                                  tile_count, n_tiles, waves, origin_lod, out, s);
}

// K3 (shade == nullptr) and K4 on a planar terrain.
extern "C" int mesh_fused_material_launch(const void* blocks, long long n_blocks,
                                          const void* ids, const void* geom,
                                          const void* tile_params, const void* fs,
                                          const void* tile_count, const void* albedo,
                                          int channels, int bits, int fast, int combined,
                                          const void* shade, void* out, int n_tiles,
                                          int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  AlbedoArgs alb;
  if (!albedo_args(blocks, albedo, channels, bits, fast, combined, shade, alb))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (shade)
    return launch_material<false, false, true>(blocks, n_blocks, ids, geom, tile_params, fs,
                                               nullptr, tile_count, n_tiles, waves,
                                               0, alb, out, s);
  return launch_material<false, false, false>(blocks, n_blocks, ids, geom, tile_params, fs,
                                              nullptr, tile_count, n_tiles, waves, 0,
                                              alb, out, s);
}

// K3 on a sphere or an ellipsoid: the spherical launch's arguments, then the
// albedo's.
extern "C" int mesh_fused_spherical_albedo_launch(
    const void* blocks, long long n_blocks, const void* ids, const void* geom,
    const void* tile_params, const void* fs, const void* hp_steps, const void* tile_count,
    const void* albedo, int channels, int bits, int fast, int combined, void* out,
    int n_tiles, int origin_lod, int ellipsoidal, int waves, void* stream) {
  if (n_tiles <= 0) return 0;
  AlbedoArgs alb;
  if (!albedo_args(blocks, albedo, channels, bits, fast, combined, nullptr, alb))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ellipsoidal)
    return launch_material<true, true, false>(blocks, n_blocks, ids, geom, tile_params, fs,
                                              hp_steps, tile_count, n_tiles, waves,
                                              origin_lod, alb, out, s);
  return launch_material<true, false, false>(blocks, n_blocks, ids, geom, tile_params, fs,
                                             hp_steps, tile_count, n_tiles, waves,
                                             origin_lod, alb, out, s);
}
