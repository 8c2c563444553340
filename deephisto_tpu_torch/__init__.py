"""deephisto_tpu_torch — the PyTorch + CUDA port of ``deephisto_tpu``.

It runs on an NVIDIA Hopper card (sm_90a) and imports nothing of JAX or of
the JAX package, which stays beside it as the reference. Public functions
keep the JAX package's layouts: (H, W, C) uint8 slides, (N, 2) int32 (y, x)
coords, NHWC activations and (H/d, W/d, C) score maps.

Layers, from the entry point down:

    predict/   exact dense full-WSI prediction (predict_full_fused)
    models/    ResNet family, flax → torch weight bridge
    ops/       patch gather (kernel K1) and stitch (kernel K2), each with its
               plain PyTorch version, which tensors on the CPU take
    csrc/      the kernels' CUDA sources, built at first use by _build.py

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
