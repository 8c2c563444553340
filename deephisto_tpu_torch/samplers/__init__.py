"""Patch samplers: the annotated-region random sampler over a device slide
bank."""

from .bank import SlideBank
from .region import AnnoRegionRndSampler, RegionTable, build_region_table
from .weights import area_weights, calc_weights

__all__ = [
    "AnnoRegionRndSampler",
    "RegionTable",
    "SlideBank",
    "area_weights",
    "build_region_table",
    "calc_weights",
]
