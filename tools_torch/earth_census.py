"""Profile the Earth flagship frame and print its top device kernels.

Twin of tools/earth_census.py on the port: the settled 60 km Earth frame
of tools_torch/earth_frame_bench.py (the spherical mesh kernel K2 every
frame) through ``Terrain.update``, its mesh taken. Prints the frame's
device total and its top 30 kernels by self CUDA time, from
``torch.profiler``, kernels only (``utils/timing.device_breakdown``), so
the spherical surplus over the planar frame can be attributed. --cpu runs
the frame on the CPU and prints its ops by self host time, named so.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from bevy_terrain_tpu_torch.math.frustum import view_projection
    from tools_torch.earth_frame_bench import RADIUS, earth_terrain, settle
    from tools_torch.scenes import top_ops

    terrain = earth_terrain(device, capacity=2048, queue=2048)
    view = np.array([0.0, 0.0, RADIUS + 60e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    out = settle(terrain, view, vp)

    def frame():
        return terrain.update({"cam": view}, {"cam": vp})["cam"].mesh.positions

    result = top_ops(frame, label="earth_census", on_card=not args.cpu)
    return {"tiles": out.tile_count, "overflow": out.overflow, **result}


if __name__ == "__main__":
    main()
