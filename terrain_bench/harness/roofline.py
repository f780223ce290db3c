"""The H100's published peaks and the least time a layer's work can take.

Peaks: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet:
HBM at 3.35 TB/s and float32 at 67 TFLOP/s outside the tensor cores.

Work, copied from the port's ``chip_smoke.py::bound`` / ``mesh_bound``
arithmetic and its operation counts (read from ``csrc/mesh_fused.cu`` and
``csrc/attach_sample.cu``; a sqrt, a division, a log2 or an exp2 counted
as one), but counted from the frame's live tile count and the
configuration's sizes, never from a kernel's arguments, so it is the same
work whatever implements the layer: each output of a live tile written
once, and the float32 operations the live tiles need. The atlas quads the
tiles read are not counted (a lower bound on the bytes), nor the Taylor
chains of high-precision steps (a lower bound on the operations).
"""

from __future__ import annotations

PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
GV2 = 17 * 17  # vertices per tile at grid size 16
# per live tile: the 33x33 tent resample (40 each) and two 1-2-1 passes (5)
OPS_TILE = 33 * 33 * 40 + 2 * 33 * 33 * 5
# per vertex: morph, window and blend (120) plus the planar distance and
# position (52), or the cube-sphere evaluations, distance and outputs (132)
OPS_VERTEX = {"planar": 172, "sphere": 252}
# per live tile and channel the unpack and resample of the half-grid; the
# exact channel sum per texel; per vertex and channel the 3x3 window; per
# vertex the sampler's window weights, the shade's normal, view and ambient
# terms and per directional light its BRDF
OPS_ALB_HALF = 33 * 33 * 27
OPS_ALB_SUM = 64 * 64 * 3
OPS_ALB_VERTEX = 29
OPS_ATTACH_VERTEX = 22
OPS_SHADE_VERTEX = 60
OPS_SHADE_DIR = 110
F32 = 4


def least_s(nbytes: float, ops: float) -> float:
    """The least time for ``nbytes`` moved and ``ops`` float32 operations."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def mesh_s(live: int, kind: str) -> float:
    """K1 (planar, 6 channels) or K2 (sphere, 9 channels: + the normal)."""
    channels = 6 if kind == "planar" else 9
    return least_s(live * channels * GV2 * F32, live * (OPS_TILE + GV2 * OPS_VERTEX[kind]))


def shaded_mesh_s(live: int, lights: int, channels: int = 4) -> float:
    """K4: the planar mesh with the albedo sampled (fast path) and shaded
    under ``lights`` directional lights, 6 mesh and ``channels`` colour
    channels out."""
    ops = (live * (OPS_TILE + GV2 * OPS_VERTEX["planar"])
           + live * channels * (OPS_ALB_HALF + GV2 * OPS_ALB_VERTEX)
           + live * GV2 * (OPS_SHADE_VERTEX + lights * OPS_SHADE_DIR))
    return least_s(live * (6 + channels) * GV2 * F32, ops)


def sampler_s(live: int, channels: int = 4) -> float:
    """K5b: a packed attachment of ``channels`` sampled at every vertex."""
    ops = live * (channels * (OPS_ALB_HALF + OPS_ALB_SUM + GV2 * OPS_ALB_VERTEX)
                  + GV2 * OPS_ATTACH_VERTEX)
    return least_s(live * GV2 * channels * F32, ops)
