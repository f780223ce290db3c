"""Source images of the examples, made in numpy and handed over in memory.

The JAX examples write their synthetic sources as PNG files and the
``Preprocessor`` reads them back with PIL. The card's machine has no PIL,
so these examples hand the ``Preprocessor`` a ``loader=`` over the arrays
instead, quantized as the files would be: what the default loader
(formats/tiff.load_source_image) returns for them. The PNG is still
written where PIL imports.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def height_source(field: np.ndarray, path) -> np.ndarray:
    """A [0, 1] height field as the 16-bit grayscale PNG that
    ``array_to_source`` writes (written to ``path`` where PIL imports),
    read back: (H, W, 1) float32."""
    if _have_pil():
        from bevy_terrain_tpu_torch.formats.tiff import array_to_source

        array_to_source(field, path)
    data = np.clip(np.rint(np.asarray(field) * 65535.0), 0, 65535).astype(np.uint16)
    return (data.astype(np.float32) / 65535.0)[..., None]


def rgba8_source(rgba: np.ndarray, path) -> np.ndarray:
    """A [0, 1] RGBA field as the 8-bit RGBA PNG the JAX examples write
    (``(rgba * 255).astype(np.uint8)``; written to ``path`` where PIL
    imports), read back: (H, W, 4) float32."""
    data = (np.asarray(rgba) * 255).astype(np.uint8)
    if _have_pil():
        from PIL import Image

        Image.fromarray(data, "RGBA").save(path)
    return data.astype(np.float32) / 255.0


def loader(sources: dict):
    """A ``Preprocessor`` loader over ``{path: (H, W, C) float32}``, with the
    default loader's channel handling (channel 0 repeated up to the
    attachment's channels, extra channels cut)."""

    def load(path, attachment_config):
        arr = sources[str(Path(path))]
        channels = attachment_config.format.channels
        if arr.shape[-1] < channels:
            arr = np.repeat(arr[..., :1], channels, axis=-1)
        return arr[..., :channels]

    return load
