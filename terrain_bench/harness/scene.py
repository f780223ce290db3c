"""A configuration file turned into the program's ``Terrain``
(``bevy_terrain_tpu_torch``, imported on call). :func:`preload` makes every
tile of the dataset resident, so a frame's tile list depends on the camera
alone.
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import numpy as np

VIEW = "cam"


def package() -> SimpleNamespace:
    """The parts of the program that a scene is built from."""
    name = "bevy_terrain_tpu_torch"
    top = importlib.import_module(name)
    return SimpleNamespace(
        Terrain=top.Terrain,
        config=importlib.import_module(f"{name}.config"),
        TerrainModel=importlib.import_module(f"{name}.math").TerrainModel,
        material=importlib.import_module(f"{name}.render.material"),
    )


def model_of(pkg, m: dict):
    if m["kind"] == "planar":
        return pkg.TerrainModel.planar(np.zeros(3), m["side_m"], m["min_height_m"],
                                       m["max_height_m"])
    return pkg.TerrainModel.sphere(np.zeros(3), m["radius_m"], m["min_height_m"],
                                   m["max_height_m"])


def terrain_config(pkg, cfg: dict, root):
    C = pkg.config
    atts = tuple(C.AttachmentConfig(name=a["name"], texture_size=a["texture_size"],
                                    border_size=a["border_size"],
                                    mip_level_count=a["mip_level_count"],
                                    format=C.AttachmentFormat(a["format"]))
                 for a in cfg["attachments"])
    return C.TerrainConfig(lod_count=cfg["lod_count"], model=model_of(pkg, cfg["model"]),
                           atlas_size=cfg["atlas_slots"], path=cfg["name"], attachments=atts,
                           assets_root=str(root))


def material_of(pkg, mat: dict):
    """The configuration's StandardMaterial over its albedo attachment."""
    M = pkg.material
    lights = tuple(M.DirectionalLight(direction=tuple(lt["direction"]), color=tuple(lt["color"]),
                                      illuminance=lt["illuminance"])
                   for lt in mat["lights"])
    return M.StandardMaterial(base_color=M.albedo_material(mat["albedo_attachment"]),
                              perceptual_roughness=mat["perceptual_roughness"],
                              metallic=mat["metallic"], reflectance=mat["reflectance"],
                              lights=lights)


VIEW_KEYS = ("tree_size", "grid_size", "tile_capacity", "refinement_count",
             "subdivision_tolerance", "morph_distance", "blend_distance", "morph_range",
             "blend_range", "precision_threshold_distance")


def build(cfg: dict, root, device, **static_overrides):
    """The program's ``Terrain`` of ``cfg`` on ``device`` with one view (the
    configuration's view settings) and its material; ``static_overrides``
    go to ``add_view``."""
    pkg = package()
    terrain = pkg.Terrain(terrain_config(pkg, cfg, root), device=device)
    v = cfg["view"]
    vc = pkg.config.TerrainViewConfig(**{k: v[k] for k in VIEW_KEYS})
    terrain.add_view(VIEW, vc, queue_capacity=v["queue_capacity"], culling=v["culling"],
                     **static_overrides)
    mat = cfg["material"]
    terrain.set_shading(material_of(pkg, mat), sample_attachments=(mat["albedo_attachment"],))
    return terrain


def preload(terrain, timeout_s: float = 600.0) -> int:
    """Request every tile of the dataset once (never released) and stream
    until all are loaded and uploaded. Returns the tile count. Raises when
    the atlas cannot hold them all or a load does not finish."""
    atlas = terrain.atlas
    state = atlas.state
    tiles = sorted(state.existing_tiles)
    if len(tiles) > atlas.atlas_size:
        raise ValueError(f"{len(tiles)} tiles do not fit the atlas's {atlas.atlas_size} slots")
    atlas.update(requested_tiles=tiles)
    deadline = time.perf_counter() + timeout_s
    while True:
        atlas.update()
        atlas.flush_uploads()
        busy = state.to_load or any(a.loading or a._staged for a in atlas.attachments)
        if not busy and all(s.loading_remaining == 0 for s in state.tile_states.values()):
            break
        if time.perf_counter() > deadline:
            raise RuntimeError("tile loads did not finish")
        time.sleep(0.001)
    if state.exhausted_requests:
        raise RuntimeError(f"{state.exhausted_requests} tile requests were denied")
    return len(tiles)
