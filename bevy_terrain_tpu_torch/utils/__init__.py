"""Utilities: synthetic dataset generation, timing, tracing.

``generate_planar_dataset`` is imported on first use: the frame's modules
import ``utils.tracing``, and ``utils.synthetic`` imports them in turn."""

__all__ = ["generate_planar_dataset"]


def __getattr__(name):
    if name == "generate_planar_dataset":
        from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

        return generate_planar_dataset
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
