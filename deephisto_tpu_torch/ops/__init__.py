"""Device ops: patch gather (kernel K1, with its multi-slide uint8 mode),
stitch (kernel K2), attention (kernel K3) and its backward (kernels K4, K5)."""

from .attention import (
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from .gather import (
    gather_multi_u8,
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
    "attention_plain",
    "coverage_footprint",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_ref",
    "gather_multi_u8",
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
