"""Geometry engine: exact polygon math on the host (numpy) and the device
(torch), and polygon rasterization (numpy)."""

from .device import (
    clip_area_batch,
    clip_area_regions,
    pad_polygon,
    pad_polygons,
    shoelace_area_device,
)
from .polygon import (
    clip_area_box,
    clip_area_boxes,
    find_self_intersections,
    is_simple_polygon,
    polygon_bounds,
    repair_polygon,
    shoelace_area,
    signed_shoelace_area,
)
from .raster import multi_class_mask, polygon_mask

__all__ = [
    "clip_area_batch",
    "clip_area_box",
    "clip_area_boxes",
    "clip_area_regions",
    "find_self_intersections",
    "is_simple_polygon",
    "multi_class_mask",
    "pad_polygon",
    "pad_polygons",
    "polygon_bounds",
    "polygon_mask",
    "repair_polygon",
    "shoelace_area",
    "shoelace_area_device",
    "signed_shoelace_area",
]
