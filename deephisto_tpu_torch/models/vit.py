"""Vision Transformer patch classifier, a port of
``deephisto_tpu/models/vit.py`` (``_attention``, ``MHA``, ``Block``, ``ViT``,
and the conv-stem ViT's bf16 serving rewrite ``FoldedStemViT`` /
``fold_vit_stem``).

Module and parameter names follow the flax model (``embed``, ``pos_embed``,
``stem_conv{i}``, ``stem_bn{i}``, ``stem_gn{i}``, ``block{i}.ln1``,
``block{i}.attn.qkv``, ``block{i}.attn.proj``, ``ln2``, ``fc1``, ``fc2``,
``ln``, ``head``), so :func:`..convert.flax_vit_to_torch` maps one onto the
other by name. The call takes NHWC input, as the JAX model does.

Attention dispatches as the JAX model does, at the card's own threshold:
from ``FLASH_MIN_SEQ`` tokens up on the card it runs kernel K3
(``ops.attention.flash_attention_qkv`` on the qkv projection), where the JAX
model runs the Pallas flash kernel on the TPU from 512; everywhere else the
port of the jnp branch (``ops.attention.attention_plain``).

Numerics follow flax: LayerNorm and GroupNorm use eps 1e-6 and reduce in
float32 on model-dtype activations; the stem's BatchNorm uses eps 1e-5;
``nn.gelu`` is the tanh approximation; convs pad as XLA's ``SAME``; Dense and
Conv layers run in the model dtype on float32 parameters cast at each call,
as flax holds and casts its params; the head is f32 on the model-dtype token
mean.

Attention is differentiable on both routes: K3's backward is kernels K4 and
K5 (``ops.attention.flash_attention`` is a ``torch.autograd.Function``), the
plain branch is plain ops. ``pos_embed`` fixes the token count to that of
``img_size``, as flax fixes it to the init input's.

With grad off (the predicts, the engine, eval steps, export) ``ViT.forward``
chains its blocks through kernel K8 (``ops.layernorm``): each residual add,
with its LayerScale, and the LayerNorm after it are one pass, so the
residual stream stays in the model dtype; each block's ``chain`` takes the
stream and its normalised copy and hands both on. On the CPU and under
``torch.export`` K8's plain versions run, today's ops in today's order. With
grad on the blocks' ``forward`` runs, as the training, pipeline and tensor-
parallel steps call it.

:class:`RegViT` is the UNI2-h pathology foundation ViT (Chen et al.,
arXiv:2308.15474; the model card's ``timm_kwargs``): a ViT with a class
token and register tokens, LayerScale and a gated (SwiGLU) MLP, its blocks
:class:`GatedBlock`. It has no counterpart in the JAX package. Its
parameters map one to one, by a rename and with the same shapes, onto
timm's ``VisionTransformer`` of the published weights:

    embed.{weight,bias}              patch_embed.proj.{weight,bias}
    cls_token, reg_token, pos_embed  cls_token, reg_token, pos_embed
    block{i}.ln1.{weight,bias}       blocks.{i}.norm1.{weight,bias}
    block{i}.attn.qkv.{weight,bias}  blocks.{i}.attn.qkv.{weight,bias}
    block{i}.attn.proj.{weight,bias} blocks.{i}.attn.proj.{weight,bias}
    block{i}.ls1                     blocks.{i}.ls1.gamma
    block{i}.ln2.{weight,bias}       blocks.{i}.norm2.{weight,bias}
    block{i}.fc1.{weight,bias}       blocks.{i}.mlp.fc1.{weight,bias}
    block{i}.fc2.{weight,bias}       blocks.{i}.mlp.fc2.{weight,bias}
    block{i}.ls2                     blocks.{i}.ls2.gamma
    ln.{weight,bias}                 norm.{weight,bias}
    head.{weight,bias}               (none: UNI2-h ships no head; a linear probe)
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_plain, flash_attention_qkv
from ..ops.layernorm import add_layernorm, layernorm
from ..ops.swiglu import swiglu
from .resnet import BatchNorm, SameConv2d, cast_param, same_pads

# From this many tokens the port takes K3 on the card. The JAX model's
# threshold, 512, comes from a TPU sweep (deephisto_tpu/models/vit.py:56);
# on an H100 80GB HBM3 at 700 W a 196-token ViT-S/16 predict of an 8192²
# slide runs 33,200 patches/s with K3 and 18,300 with the plain attention
# (chip_smoke.py phase 10), so the card takes K3 from 196 tokens up. Fewer
# tokens are not measured and keep the plain attention. The CPU runs the
# plain attention, except under torch.export, which records the card's route
# (the registered K3 op, whose CPU implementation is K3's plain version).
FLASH_MIN_SEQ = 196


def use_flash(qkv) -> bool:
    """Whether the attention over a (B, N, 3, H, Dh) qkv takes K3: on the
    card from ``FLASH_MIN_SEQ`` tokens up. Under ``torch.export`` the card's
    route is recorded whatever the tensors' device."""
    on_card = qkv.is_cuda or torch.compiler.is_compiling()
    return on_card and qkv.shape[1] >= FLASH_MIN_SEQ


def _attention(qkv, use_flash: bool) -> torch.Tensor:
    """(B, H, N, Dh) attention over a (B, N, 3, H, Dh) qkv projection:
    kernel K3 when ``use_flash`` (its backward hands the qkv gradient over
    as K5 and K4 write it), else the jnp branch's port on
    ``qkv.unbind(2)``, whose backward is one ``stack``."""
    if use_flash:
        return flash_attention_qkv(qkv, qkv.shape[-1] ** -0.5)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    return attention_plain(q, k, v)


class _SameConvBias(SameConv2d):
    """flax ``nn.Conv`` with its default bias: the SAME conv, then ``+ bias``
    in the activation dtype, as flax adds it."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return super().forward(x) + cast_param(self, "bias", x.dtype).view(1, -1, 1, 1)


class _LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics and affine in float32,
    the result in the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _norm(norm: _LayerNorm, x):
    """``norm(x)`` through K8's LayerNorm alone."""
    return layernorm(x, norm.weight, norm.bias, norm.eps)


def _add_norm(norm: _LayerNorm, x, r, gamma=None):
    """``(s, norm(s))`` for ``s = x + r`` (``x + gamma⊙r``), through K8."""
    return add_layernorm(x, r, norm.weight, norm.bias, norm.eps, gamma)


class _GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` over channels-last groups of an NCHW view: eps
    1e-6, float32 statistics, the result in the input dtype."""

    def __init__(self, groups: int, ch: int):
        super().__init__(groups, ch, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class _Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: float32 kernel and bias cast to the
    input's (the model) dtype at each call."""

    def forward(self, x):
        return F.linear(x, cast_param(self, "weight", x.dtype), cast_param(self, "bias", x.dtype))


class MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = _Dense(dim, 3 * dim)
        self.proj = _Dense(dim, dim)

    def forward(self, x):
        b, n, _ = x.shape
        # flax's column order: (3, heads, dh) within each token's 3·dim row
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, self.dim // self.heads)
        out = _attention(qkv, use_flash=use_flash(qkv))
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = _LayerNorm(dim)
        self.attn = MHA(dim, heads)
        self.ln2 = _LayerNorm(dim)
        self.fc1 = _Dense(dim, dim * mlp_ratio)
        self.fc2 = _Dense(dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)

    def chain(self, x, h, next_norm):
        """The block on the stream ``x`` given ``h = ln1(x)``: returns the
        new stream and ``next_norm`` of it, each residual add folded into
        the LayerNorm after it (K8)."""
        x, h = _add_norm(self.ln2, x, self.attn(h))
        y = F.gelu(self.fc1(h), approximate="tanh")
        return _add_norm(next_norm, x, self.fc2(y))


class ViT(nn.Module):
    """Compact ViT for patch classification, as the flax ``ViT``.

    stem: "linear" (one patch×patch SAME conv with bias), "conv" (log2(patch)
    3×3 stride-2 SAME convs + BatchNorm + ReLU, then a 1×1 conv with bias) or
    "conv_gn" (the same with GroupNorm of gcd(32, ch) groups). ``img_size``
    is the square input extent the token count (and ``pos_embed``) is built
    for."""

    def __init__(
        self,
        num_classes: int,
        patch: int = 16,
        dim: int = 384,
        depth: int = 6,
        heads: int = 6,
        dtype: torch.dtype = torch.bfloat16,
        stem: str = "linear",
        img_size: int = 224,
    ):
        super().__init__()
        if stem not in ("linear", "conv", "conv_gn"):
            raise ValueError(f"stem must be 'linear', 'conv' or 'conv_gn', got {stem!r}")
        self.num_classes, self.patch, self.dim = num_classes, patch, dim
        self.depth, self.heads, self.dtype, self.stem = depth, heads, dtype, stem
        side = img_size
        if stem == "linear":
            self.embed = _SameConvBias(3, dim, patch, patch)
            side = -(-side // patch)
        else:
            n_down = patch.bit_length() - 1
            if 1 << n_down != patch:
                raise ValueError(f"conv stem needs a power-of-2 patch, got {patch}")
            self.n_down = n_down
            cin = 3
            for i in range(n_down):
                ch = max(dim >> (n_down - 1 - i), 32)
                self.add_module(f"stem_conv{i}", SameConv2d(cin, ch, 3, 2))
                if stem == "conv_gn":
                    self.add_module(f"stem_gn{i}", _GroupNorm(math.gcd(32, ch), ch))
                else:
                    self.add_module(f"stem_bn{i}", BatchNorm(ch))
                cin = ch
                side = -(-side // 2)
            self.embed = _SameConvBias(cin, dim, 1)
        self.n_tokens = side * side
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n_tokens, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.ln = _LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)

    def embed_tokens(self, x, tokens: bool = False):
        """The (B, N, dim) token sequence the blocks take, ``pos_embed``
        added: the stem and ``embed`` of (B, H, W, C) images, or with
        ``tokens=True`` of stem features (B, gh, gw, dim)."""
        x = x.to(self.dtype)
        if not tokens:
            x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC (channels_last) memory
            if self.stem != "linear":
                norm = "stem_gn" if self.stem == "conv_gn" else "stem_bn"
                for i in range(self.n_down):
                    x = getattr(self, f"stem_conv{i}")(x)
                    x = F.relu(getattr(self, f"{norm}{i}")(x))
            x = self.embed(x).permute(0, 2, 3, 1)
        b, gh, gw, d = x.shape
        return x.reshape(b, gh * gw, d) + cast_param(self, "pos_embed", self.dtype)

    def readout(self, h):
        """The f32 head on the token mean of the final LayerNorm's output."""
        return self.head(h.mean(dim=1).float())

    def classify(self, x):
        """The final LayerNorm, the token mean and the f32 head."""
        return self.readout(self.ln(x))

    def forward(self, x, tokens: bool = False):
        """x: (B, H, W, C) images, or with ``tokens=True`` stem features
        (B, gh, gw, dim) that enter at the transformer (the JAX model's
        serving entry for a stem run outside it). Returns (B, num_classes)
        float32 logits. With grad on the blocks run one after the other;
        with grad off they are chained through K8 (the module docstring)."""
        x = self.embed_tokens(x, tokens)
        blocks = [getattr(self, f"block{i}") for i in range(self.depth)]
        if torch.is_grad_enabled():
            for block in blocks:
                x = block(x)
            return self.classify(x)
        norms = [b.ln1 for b in blocks] + [self.ln]
        h = _norm(norms[0], x)
        for block, next_norm in zip(blocks, norms[1:]):
            x, h = block.chain(x, h, next_norm)
        return self.readout(h)


ViTSmall = partial(ViT, dim=384, depth=6, heads=6)
ViTBase = partial(ViT, dim=768, depth=12, heads=12)

# ImageNet's channel statistics, the input normalisation of UNI2-h's card
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LAYER_SCALE_INIT = 1e-5  # UNI2-h's init_values, where timm starts each γ


class GatedBlock(nn.Module):
    """UNI2-h's block (timm's ``Block`` with ``init_values`` and
    ``SwiGLUPacked``): pre-norm, LayerScale on both residual branches and a
    gated MLP whose ``fc1`` packs the gate and the value (2·``hidden``
    outputs, the gate first)::

        x = x + ls1 ⊙ attn(ln1(x))
        x = x + ls2 ⊙ fc2(silu(u[:, :hidden]) ⊙ u[:, hidden:]),  u = fc1(ln2(x))

    Each LayerScale and its residual add are one ``torch.addcmul`` (float32
    inside, one rounding), the same pass as the plain ViT's residual add; γ
    stays a parameter of its own, so the weights keep timm's tensors. The
    gate is kernel K7 on the card (``ops.swiglu.swiglu``), its plain version
    on the CPU."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.ln1 = _LayerNorm(dim)
        self.attn = MHA(dim, heads)
        self.ls1 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))
        self.ln2 = _LayerNorm(dim)
        self.fc1 = _Dense(dim, 2 * hidden)
        self.fc2 = _Dense(hidden, dim)
        self.ls2 = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x):
        x = torch.addcmul(x, cast_param(self, "ls1", x.dtype), self.attn(self.ln1(x)))
        y = swiglu(self.fc1(self.ln2(x)))
        return torch.addcmul(x, cast_param(self, "ls2", x.dtype), self.fc2(y))

    def chain(self, x, h, next_norm):
        """As :meth:`Block.chain`: each LayerScale and residual add folded
        into the LayerNorm after it (K8)."""
        x, h = _add_norm(self.ln2, x, self.attn(h), cast_param(self, "ls1", x.dtype))
        y = swiglu(self.fc1(h))
        return _add_norm(next_norm, x, self.fc2(y), cast_param(self, "ls2", x.dtype))


class RegViT(ViT):
    """The UNI2-h ViT (timm's ``VisionTransformer`` with ``reg_tokens``,
    ``no_embed_class``, ``init_values`` and ``SwiGLUPacked``; the names map
    onto timm's as the module's docstring lists) with a linear head on the
    class token. A :class:`ViT`, so the predicts and the engine take it on
    the ViT's path.

    The call takes (B, H, W, 3) NHWC images in [0, 1], as :class:`ViT`:
    ImageNet's normalisation in float32, then the patch×patch stride-patch
    conv (``img_size`` a multiple of ``patch``: no padding), ``pos_embed`` on
    the patch tokens only, then ``[cls, reg × reg_tokens, patches]``, the
    :class:`GatedBlock` stack, the final LayerNorm of the class token and
    the float32 head. ``n_tokens`` counts all the tokens a patch carries."""

    def __init__(
        self,
        num_classes: int,
        patch: int = 14,
        dim: int = 1536,
        depth: int = 24,
        heads: int = 24,
        mlp_hidden: int = 4096,
        reg_tokens: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        img_size: int = 224,
    ):
        nn.Module.__init__(self)  # ViT.__init__ builds GELU blocks; its attributes are set here
        if img_size % patch:
            raise ValueError(f"the patch embedding takes an input that is a whole number of "
                             f"{patch}-px patches, got {img_size}")
        self.num_classes, self.patch, self.dim = num_classes, patch, dim
        self.depth, self.heads, self.dtype, self.stem = depth, heads, dtype, "linear"
        self.embed = _SameConvBias(3, dim, patch, patch)
        self.n_patches = (img_size // patch) ** 2
        self.n_tokens = 1 + reg_tokens + self.n_patches
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.reg_token = nn.Parameter(torch.zeros(1, reg_tokens, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n_patches, dim))
        for i in range(depth):
            self.add_module(f"block{i}", GatedBlock(dim, heads, mlp_hidden))
        self.ln = _LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD), persistent=False)
        self.embed.to(memory_format=torch.channels_last)

    def embed_tokens(self, x, tokens: bool = False):
        """The (B, 1 + reg_tokens + patches, dim) sequence the blocks take:
        of (B, H, W, 3) images, or with ``tokens=True`` of patch embeddings
        (B, gh, gw, dim)."""
        if tokens:
            x = x.to(self.dtype)
        else:
            x = ((x - self.pixel_mean) / self.pixel_std).to(self.dtype)
            x = self.embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d) + cast_param(self, "pos_embed", self.dtype)
        lead = torch.cat([cast_param(self, "cls_token", self.dtype),
                          cast_param(self, "reg_token", self.dtype)], dim=1)
        return torch.cat([lead.expand(b, -1, -1), x], dim=1)

    def readout(self, h):
        """The f32 head on the class token of the final LayerNorm's output
        (row by row, so it equals :meth:`classify`'s norm of that row)."""
        return self.head(h[:, 0].float())

    def classify(self, x):
        """The final LayerNorm of the class token and the f32 head."""
        return self.head(self.ln(x[:, 0]).float())


# the published UNI2-h (MahmoodLab/UNI2-h): 681,394,176 parameters without a head
UNI2h = partial(RegViT, patch=14, dim=1536, depth=24, heads=24, mlp_hidden=4096, reg_tokens=8)


class FoldedStemViT(nn.Module):
    """The bf16 serving rewrite of the conv-stem ViT (the JAX package's
    ``FoldedStemViT``, vit.py:268-345); build it with :func:`fold_vit_stem`.

    * The stem's eval BatchNorm is folded into its convs (one bias add
      replaces each BN).
    * The first 3×3/2 conv runs as a 2×2/1 conv over 12 channels on 2×2
      space-to-depth input (lane ``si·2 + sj``), padded (0, 1) on both axes:
      SAME at stride 2 on an even extent pads (0, 1), so its taps {0, 1, 2}
      read raw rows {2i, 2i+1, 2i+2}, packed rows i and i+1.
    * uint8 input (``wants_uint8``) takes ``stem0_kernel_u8``, the kernel with
      /255 folded in, so the predicts hand it raw bytes (K1's uint8 mode).

    The convs are bf16 ``F.conv2d`` (cuDNN on the card), as the JAX package
    runs them on XLA's conv. The transformer tail is the original ViT
    (``inner``, shared, not copied) entered at ``tokens=True``. Results
    match the float model to bf16 rounding."""

    wants_uint8 = True

    def __init__(self, model: ViT, folded: dict):
        super().__init__()
        if model.stem != "conv":
            raise ValueError(
                f"fold_vit_stem serves stem='conv' (BatchNorm folds; got stem={model.stem!r})"
            )
        self.inner = model
        self.n_down = model.n_down
        for name, t in folded.items():
            t = t.detach().to(torch.float32, copy=True)
            if t.ndim == 4:  # conv kernels, OIHW, channels_last as the model's
                t = t.contiguous(memory_format=torch.channels_last)
            self.register_buffer(name, t)

    @property
    def stem(self) -> str:
        return self.inner.stem

    def forward(self, x):
        """x: (B, H, W, 3) uint8 or float in [0, 1], H and W even. Returns
        (B, num_classes) float32 logits."""
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"s2d stem needs even spatial extents, got {tuple(x.shape)}")
        dt = self.inner.dtype
        k0 = "stem0_kernel_u8" if x.dtype == torch.uint8 else "stem0_kernel"
        # 2x2 space-to-depth: strided slices and a channel concat, lane si*2+sj
        xp = torch.cat([x[:, si::2, sj::2, :] for si in (0, 1) for sj in (0, 1)], dim=-1)
        y = xp.to(dt).permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(y, (0, 1, 0, 1)), cast_param(self, k0, dt))
        y = F.relu(y + cast_param(self, "stem0_bias", dt).view(1, -1, 1, 1))
        for i in range(1, self.n_down):
            (ty, by), (lx, rx) = same_pads(y.shape[2], 3, 2), same_pads(y.shape[3], 3, 2)
            y = F.conv2d(F.pad(y, (lx, rx, ty, by)), cast_param(self, f"stem{i}_kernel", dt),
                         stride=2)
            y = F.relu(y + cast_param(self, f"stem{i}_bias", dt).view(1, -1, 1, 1))
        y = F.conv2d(y, cast_param(self, "embed_kernel", dt))
        y = y + cast_param(self, "embed_bias", dt).view(1, -1, 1, 1)
        return self.inner(y.permute(0, 2, 3, 1), tokens=True)


@torch.no_grad()
def fold_vit_stem(model: ViT) -> FoldedStemViT:
    """The :class:`FoldedStemViT` serving rewrite of a conv-stem ViT (the JAX
    ``fold_vit_stem``, vit.py:348-389, which returns the model and its
    variables; here one module holds the folded tensors, on ``model``'s
    device, and shares ``model`` as its tail). Refuses any stem but "conv".

    The fold runs on the host in float64 from the float32 weights, then
    float32: per stem conv ``i``, ``s = γ / sqrt(σ² + 1e-5)``, kernel ``w·s``
    and bias ``β − μ·s``; the first kernel relocated into the 2×2 s2d form
    (``kp[:, lane·ci:(lane+1)·ci, dy//2, dx//2] = w[:, :, dy, dx]``, lane
    ``(dy%2)·2 + dx%2``, OIHW) with a ``/255`` copy; the embed conv's kernel
    and bias as they are."""
    if model.stem != "conv":
        raise ValueError(
            f"fold_vit_stem serves stem='conv' (BatchNorm folds; got stem={model.stem!r})"
        )
    folded: dict[str, torch.Tensor] = {}
    for i in range(model.n_down):
        k = getattr(model, f"stem_conv{i}").weight.detach().cpu().double()  # (co, ci, kh, kw)
        bn = getattr(model, f"stem_bn{i}")
        s = bn.weight.detach().cpu().double() / torch.sqrt(
            bn.running_var.detach().cpu().double() + 1e-5)
        kf = k * s[:, None, None, None]
        bias = bn.bias.detach().cpu().double() - bn.running_mean.detach().cpu().double() * s
        if i == 0:
            co, ci, kh, kw = kf.shape
            kp = torch.zeros((co, 4 * ci, 2, 2), dtype=torch.float64)
            for dy in range(kh):
                for dx in range(kw):
                    lane = (dy % 2) * 2 + dx % 2
                    kp[:, lane * ci:(lane + 1) * ci, dy // 2, dx // 2] = kf[:, :, dy, dx]
            folded["stem0_kernel"] = kp.float()
            folded["stem0_kernel_u8"] = (kp / 255.0).float()
            folded["stem0_bias"] = bias.float()
        else:
            folded[f"stem{i}_kernel"] = kf.float()
            folded[f"stem{i}_bias"] = bias.float()
    folded["embed_kernel"] = model.embed.weight.detach().float()
    folded["embed_bias"] = model.embed.bias.detach().float()
    dev = model.pos_embed.device
    return FoldedStemViT(model, {k: v.to(dev) for k, v in folded.items()}).eval()
