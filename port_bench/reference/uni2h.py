"""Plain reference of UNI2-h, the pathology foundation ViT of the model card
https://huggingface.co/MahmoodLab/UNI2-h (its ``timm_kwargs``; UNI, Chen et
al., arXiv:2308.15474; DINOv2 training, arXiv:2304.07193; register tokens,
arXiv:2309.16588), with a linear head on the class token. NHWC input in
[0, 1], from a raw state dict and the configuration's sizes (``patch``,
``dim``, ``heads``, ``depth``, ``mlp_hidden``, ``reg_tokens``), of the names
``embed``, ``cls_token``, ``reg_token``, ``pos_embed``, ``block{i}.ln1``,
``.attn.qkv``, ``.attn.proj``, ``.ls1``, ``.ln2``, ``.fc1``, ``.fc2``,
``.ls2``, ``ln`` and ``head`` (timm's ``patch_embed.proj``, ``cls_token``,
``reg_token``, ``pos_embed``, ``blocks.{i}.norm1``, ``.attn.qkv``,
``.attn.proj``, ``.ls1.gamma``, ``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``,
``.ls2.gamma``, ``norm``; UNI2-h ships no head).

Step by step, as timm's ``VisionTransformer`` computes it:

1. ImageNet's normalisation, ``(x - mean) / std`` per channel;
2. the patch embedding, a patch×patch conv at stride patch with bias (the
   input a whole number of patches: no padding);
3. ``pos_embed`` added to the patch tokens only (``no_embed_class``), then
   the class token and the ``reg_tokens`` register tokens put in front, in
   that order;
4. ``depth`` pre-norm blocks (LayerNorm eps 1e-6): ``x + ls1 ⊙ attn(ln1(x))``
   (multi-head attention, qkv with bias, its columns ordered (3, heads, dh),
   scale dh^-0.5) and ``x + ls2 ⊙ fc2(silu(u[:, :h]) ⊙ u[:, h:])`` with
   ``u = fc1(ln2(x))`` (``SwiGLUPacked``: SiLU on the first half);
5. the final LayerNorm, the class token (``global_pool`` "token"), the head.

``control`` computes the same model one precision below the program's:
every tensor the bf16 program holds in bf16 (the input, each layer's
output, the residual stream, the bf16 casts of the weights, biases, γ and
embeddings) is rounded to float8 e4m3 at one scale a tensor, every product
takes those operands (:func:`~.vit.fp8_mm`) and sums in float32, and what
the program keeps in float32 (LayerNorm's statistics and affine, the
softmax, the head) stays float32. Products of float8 operands alone, with a
float32 residual stream, come out no farther from the float32 reference
than the bf16 program at these widths (PERF.md, §6, UNI2-h), and would not
separate. Callers run it under :func:`~.common.precise` (TF32 off).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .vit import _fp8, _ln, f32_mm, fp8_mm

MEAN = (0.485, 0.456, 0.406)  # ImageNet's, as UNI2-h's card normalises
STD = (0.229, 0.224, 0.225)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def forward(sd: dict, cfg: dict, x: torch.Tensor, control: bool = False, pooled: bool = False):
    """float32 logits (B, classes) of (B, H, W, 3) float images in [0, 1];
    with ``pooled`` the (B, dim) class-token features the head takes."""
    p, dim, heads, hidden = cfg["patch"], cfg["dim"], cfg["heads"], cfg["mlp_hidden"]
    b, h, w, c = x.shape
    if h % p or w % p:
        raise ValueError(f"the patch embedding takes whole {p}-px patches, got {h}x{w}")
    mm = fp8_mm if control else f32_mm
    keep = _fp8 if control else _same  # what the program holds in bf16

    def param(name):
        return keep(sd[name].float())

    def linear(y, name):
        return keep(mm(y, sd[f"{name}.weight"].float().t()) + param(f"{name}.bias"))

    dev = x.device
    x = keep((keep(x.float()) - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev))
    gh, gw = h // p, w // p
    patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(b * gh * gw, c * p * p)  # (c, kh, kw) order, as OIHW
    wk = sd["embed.weight"].float().reshape(dim, -1)
    t = keep(mm(patches, wk.t()) + param("embed.bias"))
    t = keep(t.reshape(b, gh * gw, dim) + param("pos_embed"))
    lead = torch.cat([param("cls_token"), param("reg_token")], dim=1)
    t = torch.cat([lead.expand(b, -1, -1), t], dim=1)
    dh = dim // heads
    for i in range(cfg["depth"]):
        pre = f"block{i}"
        qkv = linear(keep(_ln(t, sd, f"{pre}.ln1")), f"{pre}.attn.qkv")
        q, k, v = (qkv.reshape(b, -1, 3, heads, dh)[:, :, j].transpose(1, 2)
                   for j in range(3))  # (B, H, N, dh)
        att = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        o = keep(mm(att, v)).transpose(1, 2).reshape(b, -1, dim)
        t = keep(t + param(f"{pre}.ls1") * linear(o, f"{pre}.attn.proj"))
        u = linear(keep(_ln(t, sd, f"{pre}.ln2")), f"{pre}.fc1")
        y = keep(F.silu(u[..., :hidden]) * u[..., hidden:])
        t = keep(t + param(f"{pre}.ls2") * linear(y, f"{pre}.fc2"))
    f = keep(_ln(t, sd, "ln")[:, 0])
    if pooled:
        return f
    return f @ sd["head.weight"].float().t() + sd["head.bias"].float()
