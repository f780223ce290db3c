"""On-disk formats: the ``config.tc`` tile manifest (see tc.py) and the
source imagery loader (tiff.py, PIL imported on use). Tile payloads are
handled by terrain_data/attachment.py."""

from bevy_terrain_tpu_torch.formats.tc import TC

__all__ = ["TC"]
