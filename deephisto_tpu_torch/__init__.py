"""deephisto_tpu_torch — the PyTorch + CUDA port of ``deephisto_tpu``.

It runs on an NVIDIA Hopper card (sm_90a) and imports nothing of JAX or of
the JAX package, which stays beside it as the reference. Public functions
keep the JAX package's layouts: (H, W, C) uint8 slides, (N, 2) int32 (y, x)
coords, NHWC activations and (H/d, W/d, C) score maps.

Layers, from the entry point down:

    predict/   exact dense full-WSI prediction (predict_full_fused) and the
               fcn serving mode (predict_full_fcn)
    models/    ResNet and ViT families, int8 PTQ of the ResNet, flax → torch
               weight bridge
    train/, samplers/, slide/, anno/, geometry/, data/
               training over the annotated region sampler
    ops/       patch gather (kernel K1), stitch (K2), flash attention (K3)
               and its backward (K4, K5), int8 conv (K6), each with its
               plain PyTorch version, which tensors on the CPU take
    csrc/      the kernels' CUDA sources, built at first use by _build.py

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
