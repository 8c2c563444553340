"""Geometry engine: exact polygon math on the host (numpy) and the device
(torch), and polygon rasterization (numpy)."""

from .device import clip_area_batch, pad_polygon, pad_polygons
from .polygon import (
    clip_area_boxes,
    find_self_intersections,
    is_simple_polygon,
    polygon_bounds,
    repair_polygon,
    shoelace_area,
    signed_shoelace_area,
)
from .raster import polygon_mask

__all__ = [
    "clip_area_batch",
    "clip_area_boxes",
    "find_self_intersections",
    "is_simple_polygon",
    "pad_polygon",
    "pad_polygons",
    "polygon_bounds",
    "polygon_mask",
    "repair_polygon",
    "shoelace_area",
    "signed_shoelace_area",
]
