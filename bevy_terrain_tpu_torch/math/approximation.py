"""Per-view second-order Taylor approximation of the cube-sphere surface.

Behavioral twin of reference src/math/terrain_model.rs:222-360.

The approximation maps st coordinates relative to the view (at ``origin_lod``
resolution) to world positions *relative to the view* — this is what lets f32
device kernels compute sub-meter-accurate positions on a 6.4e6 m ellipsoid
(the reference's high-precision trick; consumed by
src/shaders/functions.wgsl:98-115). Computed on host in f64 once per frame
per view (6 sides, trivial cost), shipped to the device as small f32 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bevy_terrain_tpu_torch.math.coordinate import C_SQR, Coordinate

# One matrix per side, shuffling the (a, b, c) basis into cube xyz
# (reference terrain_model.rs:14-21, DMat3::from_cols_array => column-major).
SIDE_MATRICES = np.stack(
    [
        np.array(cols, dtype=np.float64).reshape(3, 3, order="F")
        for cols in [
            [-1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0],
            [0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, -1.0, 0.0],
            [0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 1.0],
            [0.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0, 0.0, 0.0],
            [0.0, -1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0],
        ]
    ]
)


@dataclasses.dataclass
class TerrainModelApproximation:
    """Device-ready per-view Taylor parameters (reference terrain_model.rs:228-259).

    Arrays are stacked over the 6 sides; planar terrains only use side 0
    (and only ``origin_xy``/``origin_uv``, for the subdivision coordinate).
    """

    origin_lod: int
    approximate_height: float
    origin_xy: np.ndarray  # (6, 2) int32 — view tile index at origin_lod per side
    origin_uv: np.ndarray  # (6, 2) f32 — view uv within that tile
    c: np.ndarray  # (6, 3) f32 — constant coefficient
    c_s: np.ndarray  # (6, 3) f32
    c_t: np.ndarray  # (6, 3) f32
    c_ss: np.ndarray  # (6, 3) f32 (pre-multiplied by 0.5)
    c_st: np.ndarray  # (6, 3) f32
    c_tt: np.ndarray  # (6, 3) f32 (pre-multiplied by 0.5)

    @staticmethod
    def compute(
        model,
        view_world_position,
        origin_lod: int,
        approximate_height: float,
    ) -> "TerrainModelApproximation":
        """Reference terrain_model.rs:263-360 (analytic derivative chain)."""
        view_world_position = np.asarray(view_world_position, np.float64)
        origin_count = float(1 << origin_lod)

        from bevy_terrain_tpu_torch import native

        if model.kind == "spherical" and native.available():
            # C++ full path for true spheres (tr_taylor_from_world): face
            # pick + warp + 6-side projection + derivative chain, one call;
            # ellipsoids keep the host bisection projector below.
            # Fuzz-tested in test_torch_native.py.
            m = np.asarray(model.world_from_local, np.float64)
            lm = np.asarray(model.local_from_world, np.float64)
            oxy, ouv, co = native.taylor_from_world(
                view_world_position, m[:3, :4], lm[:3, :4], origin_count
            )
            return TerrainModelApproximation(
                origin_lod=origin_lod,
                approximate_height=float(approximate_height),
                origin_xy=oxy, origin_uv=ouv,
                c=co[0], c_s=co[1], c_t=co[2],
                c_ss=co[3], c_st=co[4], c_tt=co[5],
            )

        view_coordinate = Coordinate.from_world_position(view_world_position, model)

        # vectorized over all 6 sides at once (same math as the reference's
        # per-side loop; ~4x less host time per frame than scalar python)
        if model.is_spherical:
            from bevy_terrain_tpu_torch.math.coordinate import project_uv_to_side

            uv = project_uv_to_side(
                np.full(6, view_coordinate.side, np.int32),
                np.arange(6, dtype=np.int32),
                np.broadcast_to(np.asarray(view_coordinate.uv, np.float64), (6, 2)),
            )
        else:
            uv = np.broadcast_to(np.asarray(view_coordinate.uv, np.float64), (6, 2))
        scaled = uv * origin_count
        origin_xy = scaled.astype(np.int64).astype(np.int32)
        origin_uv = (scaled % 1.0).astype(np.float32)

        if not model.is_spherical:
            # planar terrains consume ONLY origin_xy/origin_uv (the
            # subdivision coordinate, functions.wgsl:133-154); the Taylor
            # relative-position path never runs (HIGH_PRECISION is a
            # spherical concern here), so skip the derivative chain
            # (~0.3 ms/frame of host numpy)
            zero = np.zeros((6, 3), np.float32)
            return TerrainModelApproximation(
                origin_lod=origin_lod,
                approximate_height=float(approximate_height),
                origin_xy=origin_xy,
                origin_uv=origin_uv,
                c=zero, c_s=zero, c_t=zero, c_ss=zero, c_st=zero, c_tt=zero,
            )

        from bevy_terrain_tpu_torch import native

        if native.available():
            # C++ path (terrain_runtime.cpp tr_taylor_spherical): the same
            # f64 chain as below without numpy's small-array overhead;
            # fuzz-tested in test_torch_native.py
            m3x4 = np.asarray(model.world_from_local, np.float64)[:3, :4]
            oxy, ouv, co = native.taylor_spherical(
                uv, view_world_position, m3x4, origin_count
            )
            return TerrainModelApproximation(
                origin_lod=origin_lod,
                approximate_height=float(approximate_height),
                origin_xy=oxy, origin_uv=ouv,
                c=co[0], c_s=co[1], c_t=co[2],
                c_ss=co[3], c_st=co[4], c_tt=co[5],
            )

        s = uv[:, 0]
        t = uv[:, 1]  # (6,)

        # u(s) = (2s-1)/sqrt(1-4Cs(s-1)), v(t) likewise
        # (reference terrain_model.rs:279-302). Powers are repeated
        # products, as the native runtime computes them.
        ud = np.sqrt(1.0 - 4.0 * C_SQR * s * (s - 1.0))
        u = (2.0 * s - 1.0) / ud
        u_ds = 2.0 * (C_SQR + 1.0) / (ud * ud * ud)
        u_dss = 12.0 * C_SQR * (C_SQR + 1.0) * (2.0 * s - 1.0) / (ud * ud * ud * ud * ud)

        vd = np.sqrt(1.0 - 4.0 * C_SQR * t * (t - 1.0))
        v = (2.0 * t - 1.0) / vd
        v_dt = 2.0 * (C_SQR + 1.0) / (vd * vd * vd)
        v_dtt = 12.0 * C_SQR * (C_SQR + 1.0) * (2.0 * t - 1.0) / (vd * vd * vd * vd * vd)

        # l(s,t) = sqrt(1 + u^2 + v^2) and derivatives
        # (reference terrain_model.rs:304-309)
        l = np.sqrt(1.0 + u * u + v * v)
        l3 = l * l * l
        l_ds = u * u_ds / l
        l_dt = v * v_dt / l
        l_dss = (u * u_dss * l * l + (v * v + 1.0) * u_ds * u_ds) / l3
        l_dst = -(u * v * u_ds * v_dt) / l3
        l_dtt = (v * v_dtt * l * l + (u * u + 1.0) * v_dt * v_dt) / l3

        # quotient-rule chains for a=1/l, b=u/l, c=v/l scaled by powers of l
        # (reference terrain_model.rs:311-330)
        ones = np.ones_like(l)
        a = ones
        a_ds = -l_ds
        a_dt = -l_dt
        a_dss = 2.0 * l_ds * l_ds - l * l_dss
        a_dst = 2.0 * l_ds * l_dt - l * l_dst
        a_dtt = 2.0 * l_dt * l_dt - l * l_dtt

        b = u
        b_ds = -u * l_ds + l * u_ds
        b_dt = -u * l_dt
        b_dss = 2.0 * u * l_ds * l_ds - l * (2.0 * u_ds * l_ds + u * l_dss) + u_dss * l * l
        b_dst = 2.0 * u * l_ds * l_dt - l * (u_ds * l_dt + u * l_dst)
        b_dtt = 2.0 * u * l_dt * l_dt - l * u * l_dtt

        c = v
        c_ds = -v * l_ds
        c_dt = -v * l_dt + l * v_dt
        c_dss = 2.0 * v * l_ds * l_ds - l * v * l_dss
        c_dst = 2.0 * v * l_ds * l_dt - l * (v_dt * l_ds + v * l_dst)
        c_dtt = 2.0 * v * l_dt * l_dt - l * (2.0 * v_dt * l_dt + v * l_dtt) + v_dtt * l * l

        # per side: rotate (a, b, c) into cube xyz, scale by 1/l^power, map
        # to world. Written as the native runtime writes it
        # (terrain_runtime.cpp tr_taylor_spherical: explicit 3-term sums,
        # 1/l^power by repeated division, c = w + (translation - view)), so
        # the f32 coefficients match it bit for bit, signs of zero included
        m = np.asarray(model.world_from_local, np.float64)[:3, :4]
        view = view_world_position

        def tp(vec, power, scale=1.0, translate=False):
            M = SIDE_MATRICES
            rot = (M[:, :, 0] * vec[:, None, 0] + M[:, :, 1] * vec[:, None, 1]
                   + M[:, :, 2] * vec[:, None, 2])  # (6, 3)
            inv = np.ones_like(l)
            for _ in range(power):
                inv = inv / l
            rot = rot * inv[:, None]
            w = (m[None, :, 0] * rot[:, 0:1] + m[None, :, 1] * rot[:, 1:2]
                 + m[None, :, 2] * rot[:, 2:3])  # (6, 3)
            if translate:
                w = w + (m[:, 3] - view)
            return (scale * w).astype(np.float32)

        coeffs = {
            "c": tp(np.stack([a, b, c], axis=-1), 1, translate=True),
            "c_s": tp(np.stack([a_ds, b_ds, c_ds], axis=-1), 2),
            "c_t": tp(np.stack([a_dt, b_dt, c_dt], axis=-1), 2),
            "c_ss": tp(np.stack([a_dss, b_dss, c_dss], axis=-1), 3, 0.5),
            "c_st": tp(np.stack([a_dst, b_dst, c_dst], axis=-1), 3),
            "c_tt": tp(np.stack([a_dtt, b_dtt, c_dtt], axis=-1), 3, 0.5),
        }

        return TerrainModelApproximation(
            origin_lod=origin_lod,
            approximate_height=float(approximate_height),
            origin_xy=origin_xy,
            origin_uv=origin_uv,
            **coeffs,
        )
