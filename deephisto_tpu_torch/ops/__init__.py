"""Device ops: preprocessing and flip augmentation, weighted sampling
(Gumbel-max and Gumbel-top-k, torch ops), patch gather (kernel K1, with its multi-slide uint8 mode and
its int8 mode, the int8 model's input quantize and stem layout fused in),
stitch (kernel K2), attention (kernel K3) and its backward (kernels K4, K5),
and the int8 convolution with its epilogue, the ResNet block's among its
modes (kernel K6)."""

from .attention import (
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_qkv,
    flash_attention_ref,
)
from .augment import preprocess_batch, preprocess_batch_per_sample

# the module's entry points; ``ops.conv_int8`` stays the module
from .conv_int8 import (
    conv_f32,
    conv_int8_block,
    conv_int8_block_ref,
    conv_int8_ref,
    conv_to_int8,
)
from .gather import (
    gather_multi_u8,
    gather_normalize,
    gather_normalize_ref,
    gather_patches,
    gather_patches_multi,
    gather_quantize_int8,
    gather_quantize_int8_ref,
    s2d_pack4,
    u8_table,
    unpack_s2d8,
)
from .sampling import (
    categorical,
    coverage_cell_topk,
    gumbel,
    gumbel_topk,
    log_weights,
    top_k,
    uniform_int,
)
from .stitch import (
    accumulate_coverage,
    coverage_footprint,
    map_footprint,
    scatter_add_map,
    scatter_add_map_exact,
    scatter_add_map_ref,
)

__all__ = [
    "accumulate_coverage",
    "attention_plain",
    "categorical",
    "coverage_cell_topk",
    "conv_f32",
    "conv_int8_block",
    "conv_int8_block_ref",
    "conv_int8_ref",
    "conv_to_int8",
    "coverage_footprint",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_qkv",
    "flash_attention_ref",
    "gather_multi_u8",
    "gather_normalize",
    "gather_normalize_ref",
    "gather_patches",
    "gather_patches_multi",
    "gather_quantize_int8",
    "gather_quantize_int8_ref",
    "gumbel",
    "gumbel_topk",
    "log_weights",
    "map_footprint",
    "preprocess_batch",
    "preprocess_batch_per_sample",
    "scatter_add_map",
    "scatter_add_map_exact",
    "scatter_add_map_ref",
    "s2d_pack4",
    "top_k",
    "u8_table",
    "uniform_int",
    "unpack_s2d8",
]
