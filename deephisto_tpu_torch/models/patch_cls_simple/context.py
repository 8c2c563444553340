"""Context-consistent training, a port of
``deephisto_tpu/models/patch_cls_simple/context.py``: train the way the fcn
predict mode serves.

A model trained on bare 224² patches bakes the conv zero-padding at patch
borders into its features; served fully convolutionally
(``predict/fcn.py``), its windows see real tissue where training showed it
zeros. ``ContextWindowModel`` wraps a ResNet-family model with the serving
forward: the backbone runs convolutionally on the patch plus ``context``
pixels of real surroundings a side, and the head classifies the centre
``patch_size`` block of the stride-32 feature map, the features the fcn mode
computes. It is an ``nn.Module`` that ``make_fused_epoch``,
``make_fused_eval`` and ``make_steps`` take unchanged (the trainer gathers
context windows when ``model.context`` > 0); its parameters and BatchNorm
statistics are the wrapped model's (``inner``), in the same order, so the
optimizer state and the checkpoint (a plain base-model checkpoint, which
``predict_full_fcn`` loads) line up.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FEATURE_STRIDE = 32  # ResNet total stride (predict/fcn.py)


class ContextWindowModel(nn.Module):
    """Classify the CENTER ``patch_size`` block of a larger context window from
    convolutional features. Input: (B, patch_size + 2*context,
    patch_size + 2*context, C), NHWC; both ``patch_size`` and ``context``
    must be non-negative multiples of 32."""

    def __init__(self, model: nn.Module, patch_size: int = 224, context: int = 64):
        super().__init__()
        if patch_size % FEATURE_STRIDE or context % FEATURE_STRIDE or context < 0:
            raise ValueError("patch_size and context must be non-negative multiples of 32")
        self.inner = model
        self.patch_size = patch_size
        self.context = context

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.context // FEATURE_STRIDE
        wf = self.patch_size // FEATURE_STRIDE
        feat = self.inner(x, features=True)[:, c:c + wf, c:c + wf]
        pooled = feat.float().mean(dim=(1, 2))
        fc = self.inner.fc
        # the head in float32 whatever the model's dtype (context.py:74-84)
        return F.linear(pooled, fc.weight.float(), fc.bias.float())
