"""Debug subsystem: runtime toggles + camera paths (a copy of the JAX
package's ``debug/__init__.py``, numpy only).

Twin of the reference's ``TerrainDebugPlugin`` (src/debug/mod.rs): the
``DebugTerrain`` resource's 17 keyboard toggles (mod.rs:66-214) become a
dataclass whose fields map onto pipeline-specialization flags (each change
rebuilds the views' static configs, like the reference's shader-def
specialization) and shading options; the debug fly camera (debug/camera.rs)
becomes deterministic camera paths for examples and benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DebugTerrain:
    """Runtime debug toggles (reference src/debug/mod.rs:24-88 defaults)."""

    # wireframe: the reference flips the rasterizer's polygon mode
    # (terrain_material.rs:299-303); here the shaded output gets a
    # tile-border/lattice darkening overlay (material.wireframe_overlay)
    wireframe: bool = False
    show_data_lod: bool = False
    show_geometry_lod: bool = False
    show_tile_tree: bool = False
    show_pixels: bool = False
    show_uv: bool = False
    show_normals: bool = False
    morph: bool = True
    blend: bool = True
    tile_tree_lod: bool = False
    lighting: bool = True
    sample_grad: bool = True
    high_precision: bool = True
    # pin every view's tile list (Terrain.set_debug): refinement is skipped
    # and the frozen list re-meshes from the moving camera — the reference
    # skips the tiling prepass the same way (debug/mod.rs:186-192,
    # tiling_prepass.rs:230-232)
    freeze: bool = False
    # TEST1-3 map to shader defs that NO shader in the reference snapshot
    # references (grep TEST1|TEST2|TEST3 over src/shaders/* is empty); they
    # exist purely as respecialization hooks (terrain_material.rs:93-97).
    # Kept with identical semantics: toggling them changes the static
    # config and nothing else.
    test1: bool = False
    test2: bool = False
    test3: bool = False

    @property
    def debug_view(self):
        """Active view(s) with fragment_debug's overwrite order
        (fragment.wgsl:69-87): uv/normals replace last (wiping the pixel
        overlay); otherwise show_pixels mixes 50% over whichever of
        data_lod/geometry_lod/tile_tree (or the plain material) is showing.
        Returns a view name, a tuple of them, or None — the shapes
        render/material.shade accepts."""
        if self.show_normals:
            return "normals"
        if self.show_uv:
            return "uv"
        base = (
            "tile_tree" if self.show_tile_tree
            else "geometry_lod" if self.show_geometry_lod
            else "data_lod" if self.show_data_lod
            else None
        )
        if self.show_pixels:
            return (base, "pixels") if base else "pixels"
        return base

    def static_overrides(self) -> dict:
        """Flags that specialize the frame stage
        (reference terrain_material.rs:174-227)."""
        return {
            "morph": self.morph,
            "blend": self.blend,
            "tile_tree_lod": self.tile_tree_lod,
            "sample_grad": self.sample_grad,
            "test1": self.test1,
            "test2": self.test2,
            "test3": self.test3,
        }


@dataclasses.dataclass
class OrbitCamera:
    """Deterministic flythrough path (debug/camera.rs stand-in for
    benchmarks and goldens)."""

    center: np.ndarray
    radius: float
    height: float
    height_amplitude: float = 0.0
    revolutions: float = 1.0

    def position(self, t: float) -> np.ndarray:
        angle = 2.0 * np.pi * self.revolutions * t
        return np.asarray(self.center) + np.array(
            [
                self.radius * np.cos(angle),
                self.height + self.height_amplitude * np.sin(3.0 * angle),
                self.radius * np.sin(angle),
            ]
        )

    def path(self, frames: int) -> list[np.ndarray]:
        return [self.position(i / max(frames - 1, 1)) for i in range(frames)]


@dataclasses.dataclass
class ApproachCamera:
    """Zoom-in path: far orbit to near-surface approach (stresses the
    streaming + LOD machinery like the swisstopo flythrough config)."""

    target: np.ndarray
    start_distance: float
    end_distance: float
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.3, 0.8, 0.52])
    )

    def position(self, t: float) -> np.ndarray:
        d = self.start_distance * (self.end_distance / self.start_distance) ** t
        dir_n = self.direction / np.linalg.norm(self.direction)
        return np.asarray(self.target) + d * dir_n

    def path(self, frames: int) -> list[np.ndarray]:
        return [self.position(i / max(frames - 1, 1)) for i in range(frames)]


@dataclasses.dataclass
class FlyCamera:
    """Smoothed free-fly camera controller (reference debug/camera.rs:8-204).

    The reference's DebugCameraController as a headless update law —
    callers feed per-tick move/look inputs (keyboard/gamepad/script)
    instead of Bevy events, and positions stay f64 (the reference's
    big_space high-precision path needs no separate integer grid here):

    * translation velocity lerps toward ``direction * speed * dt`` with
      factor ``1 - translational_smoothness`` (camera.rs:171-181)
    * rotation velocity lerps likewise (rotational_smoothness)
    * ``accelerate`` input multiplies the speed by
      ``1 + accel * acceleration_speed * dt`` (camera.rs:183)
    * yaw wraps at tau; pitch clamps to +/- pi/2 (camera.rs:185-188)
    * the move direction is rotated into the camera basis before
      integrating (camera.rs:168)
    """

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    yaw: float = 0.0
    pitch: float = 0.0
    translational_smoothness: float = 0.9  # camera.rs defaults :92-100
    rotational_smoothness: float = 0.8
    translation_speed: float = 100.0
    rotation_speed: float = 0.1
    acceleration_speed: float = 4.0
    translation_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    rotation_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )

    def basis(self) -> np.ndarray:
        """Rows = right, up, forward of the camera orientation
        (yaw about +Y then pitch about +X, reference EulerRot::YXZ)."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        right = np.array([cy, 0.0, -sy])
        up = np.array([sy * sp, cp, cy * sp])
        forward = np.array([-sy * cp, sp, -cy * cp])
        return np.stack([right, up, forward])

    def update(self, dt: float, move=(0.0, 0.0, 0.0), look=(0.0, 0.0),
               accelerate: float = 0.0) -> np.ndarray:
        """One controller tick; returns the new position (f64 (3,)).

        ``move`` = (right, up, forward) in [-1, 1]; ``look`` = (yaw,
        pitch) deltas (the reference feeds -mouse_delta); ``accelerate``
        in [-1, 1] (the reference's Home/End keys).
        """
        right, up, forward = self.basis()
        direction = move[0] * right + move[1] * up + move[2] * forward

        lerp_t = 1.0 - min(max(self.translational_smoothness, 0.0), 0.999)
        lerp_r = 1.0 - min(max(self.rotational_smoothness, 0.0), 0.999)
        vel_target = direction * self.translation_speed * dt
        rot_target = np.asarray(look, np.float64) * self.rotation_speed * dt
        self.translation_velocity = (
            self.translation_velocity
            + (vel_target - self.translation_velocity) * lerp_t
        )
        self.rotation_velocity = (
            self.rotation_velocity
            + (rot_target - self.rotation_velocity) * lerp_r
        )
        self.translation_speed *= 1.0 + accelerate * self.acceleration_speed * dt

        self.yaw = (self.yaw + self.rotation_velocity[0]) % (2.0 * np.pi)
        self.pitch = float(
            np.clip(self.pitch + self.rotation_velocity[1],
                    -np.pi / 2.0, np.pi / 2.0)
        )
        self.position = np.asarray(self.position, np.float64) + self.translation_velocity
        return self.position

    def view_projection(self, fov_y: float = np.pi / 3,
                        aspect: float = 16 / 9) -> np.ndarray:
        """Culling matrix for the current pose (math/frustum.py)."""
        from bevy_terrain_tpu_torch.math.frustum import view_projection

        return view_projection(
            self.position, self.position + self.basis()[2], fov_y, aspect
        )
