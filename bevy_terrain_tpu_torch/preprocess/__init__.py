"""Offline preprocessing (L4): source imagery -> streamed tile datasets.

See :mod:`bevy_terrain_tpu_torch.preprocess.preprocessor` (task-graph twin
of the reference's src/preprocess/), :mod:`bevy_terrain_tpu_torch.ops.preprocess`
(the host split/downsample/stitch data ops) and
:mod:`bevy_terrain_tpu_torch.ops.preprocess_device` (the same as torch ops
over whole-lod stacks)."""

from bevy_terrain_tpu_torch.preprocess.preprocessor import (
    PreprocessDataset,
    Preprocessor,
    SphericalDataset,
    reset_directory,
)

__all__ = [
    "PreprocessDataset",
    "Preprocessor",
    "SphericalDataset",
    "reset_directory",
]
