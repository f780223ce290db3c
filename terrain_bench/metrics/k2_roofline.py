"""K2 (``mesh_fused_spherical`` on a sphere, ``csrc/mesh_fused.cu``'s
``mesh_fused_kernel<true, false, 0>``): the least time of the frame's live
tiles' work over the kernel's device time, in percent, median over the
traced frames."""

from harness import layers, roofline

PATTERN = r"mesh_fused_kernel<true, false, 0>"


def read(t):
    return layers.roofline_pct(t, PATTERN, lambda live: roofline.mesh_s(live, "sphere"))
