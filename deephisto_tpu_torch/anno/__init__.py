"""Annotation layer: class registry, palette, parsing, visualization (the
port's copy of ``deephisto_tpu/anno``)."""

from .classes import AnnoClass, AnnoDescription
from .palette import Palette, get_distinct_colors
from .parse import RegionAnnotation, parse_annotations
from .visualize import AnnoVisualizer, AnnoVisualizerParams, PatchVisAccent

__all__ = [
    "AnnoClass",
    "AnnoDescription",
    "AnnoVisualizer",
    "AnnoVisualizerParams",
    "Palette",
    "PatchVisAccent",
    "RegionAnnotation",
    "get_distinct_colors",
    "parse_annotations",
]
