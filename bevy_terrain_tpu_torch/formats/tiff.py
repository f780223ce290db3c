"""Source imagery loading (GeoTIFF-ish), a copy of the JAX package's
``formats/tiff.py`` (twin of the reference's TiffLoader, tiff.rs:14-62: all
sample types cast to the attachment's dtype). PIL is imported inside the
functions, so the package imports without it; where PIL is absent, hand the
``Preprocessor`` a ``loader=`` that returns the source array. 16-bit
PNG/TIFF keep their precision. Normalizes to (H, W, C) float32 in [0, 1]
with 0 == nodata.
"""

from __future__ import annotations

import numpy as np


def load_source_image(path: str, attachment_config) -> np.ndarray:
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # reader.no_limits() (tiff.rs via tile_atlas.rs:130)
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    channels = attachment_config.format.channels
    if arr.shape[-1] < channels:
        arr = np.repeat(arr[..., :1], channels, axis=-1)
    arr = arr[..., :channels]

    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if arr.dtype in (np.float32, np.float64):
        return arr.astype(np.float32)
    if arr.dtype == np.int16:
        return np.clip(arr.astype(np.float32) / 32767.0, 0.0, 1.0)
    return arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)


def array_to_source(arr: np.ndarray, path: str) -> None:
    """Write a float [0,1] array as a 16-bit grayscale PNG source image
    (for tests / synthetic datasets)."""
    from PIL import Image

    data = np.clip(np.rint(np.asarray(arr) * 65535.0), 0, 65535).astype(np.uint16)
    if data.ndim == 3:
        data = data[..., 0]
    Image.fromarray(data).save(path)
