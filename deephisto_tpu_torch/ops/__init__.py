"""Device ops: patch gather (kernel K1) and stitch (kernel K2)."""

from .gather import (
    gather_normalize,
    gather_normalize_ref,
    gather_patches,
    gather_patches_multi,
    u8_table,
)
from .stitch import (
    coverage_footprint,
    map_footprint,
    scatter_add_map,
    scatter_add_map_exact,
    scatter_add_map_ref,
)

__all__ = [
    "coverage_footprint",
    "gather_normalize",
    "gather_normalize_ref",
    "gather_patches",
    "gather_patches_multi",
    "map_footprint",
    "scatter_add_map",
    "scatter_add_map_exact",
    "scatter_add_map_ref",
    "u8_table",
]
