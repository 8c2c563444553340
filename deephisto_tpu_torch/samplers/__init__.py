"""Patch samplers: the annotated-region random and dense samplers over a
slide bank (on the device, or on the host), the test-set extraction, the
multi-magnification bank, and the whole-slide random and dense samplers."""

from .bank import SlideBank
from .full import FullImageDenseSampler, FullImageRndSampler, SamplerExecutionMode
from .multimag import MultiMagBank, make_multimag_sample_fn, stack_mags_as_channels
from .region import (
    AnnoRegionDenseSampler,
    AnnoRegionRndSampler,
    RegionTable,
    build_region_table,
    extract_and_save_subset,
)
from .weights import area_weights, calc_weights

__all__ = [
    "AnnoRegionDenseSampler",
    "AnnoRegionRndSampler",
    "FullImageDenseSampler",
    "FullImageRndSampler",
    "MultiMagBank",
    "RegionTable",
    "SamplerExecutionMode",
    "SlideBank",
    "area_weights",
    "build_region_table",
    "calc_weights",
    "extract_and_save_subset",
    "make_multimag_sample_fn",
    "stack_mags_as_channels",
]
