"""Tile loads that finish in step with the frame that starts them.

Which tiles are resident in a frame, and with them its tile count and the
approximate height under the camera, depends on how far the background tile
loads have got, that is on the host's timing. Two runs of the same frames
(two packages, the native and the numpy host paths, two processes) see the
same resident tiles only when every load finishes before the frame goes on.
The pipeline never does this itself; the parity tests and ``chip_smoke.py``
do, through :func:`loads_in_step`.
"""

from __future__ import annotations

import contextlib
from concurrent import futures


@contextlib.contextmanager
def loads_in_step(*attachment_classes):
    """Within the block, ``start_loading`` of each of ``attachment_classes``
    waits for the load it started before it returns. Takes the
    ``AtlasAttachment`` class of this package or of the JAX package: both
    start a load with ``start_loading(self, pool, tile)`` and queue its
    future first in ``self.loading[-1]``."""
    originals = [(cls, cls.start_loading) for cls in attachment_classes]

    def in_step(start):
        def start_loading(self, pool, tile):
            start(self, pool, tile)
            futures.wait([self.loading[-1][0]])
        return start_loading

    for cls, start in originals:
        cls.start_loading = in_step(start)
    try:
        yield
    finally:
        for cls, start in originals:
            cls.start_loading = start
