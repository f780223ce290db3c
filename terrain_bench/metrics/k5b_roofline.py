"""K5b (``attach_sample_fused_packed``, ``csrc/attach_sample.cu``'s
``attach_sample_kernel``) sampling the Rgba8 albedo at every vertex: the
least time of the frame's live tiles' work over the kernel's device time,
in percent, median over the traced frames."""

from harness import layers, roofline

PATTERN = r"attach_sample_kernel"


def read(t):
    return layers.roofline_pct(t, PATTERN, lambda live: roofline.sampler_s(live, 4))
