"""K4 (``mesh_fused_shaded``: the planar mesh kernel with the albedo and its
shade, ``csrc/mesh_fused.cu``'s ``mesh_material_kernel<false, false, true,
0>``): the least time of the frame's live tiles' work over the kernel's
device time, in percent, median over the traced frames."""

from harness import layers, roofline

PATTERN = r"mesh_material_kernel<false, false, true, 0>"


def read(t):
    lights = len(t["config"]["material"]["lights"])
    return layers.roofline_pct(t, PATTERN, lambda live: roofline.shaded_mesh_s(live, lights))
