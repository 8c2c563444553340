"""Annotation parsing."""

from .parse import RegionAnnotation, parse_annotations

__all__ = ["RegionAnnotation", "parse_annotations"]
