"""Post-training int8 quantization of the ViT family (W8A8), a port of
``deephisto_tpu/models/quantize_vit.py`` (``calibrate_vit``,
``QuantizedViT``, ``quantize_vit``).

* The Dense layers (qkv, proj, fc1, fc2) take int8 activations at a
  per-tensor calibrated scale and int8 weights at per-output-channel scales:
  an s8 × s8 → s32 product, then ``y.float()·dequant + bias`` in f32, two
  roundings, never a fused multiply-add. On the card the product is
  ``torch._int_mm`` (the JAX package computes it with XLA's ``dot_general``,
  outside any Pallas kernel); its plain version, which CPU tensors take, is a
  float64 product of the integer values cast to int32 (exact: |y| ≤ 127²·K
  < 2⁵³). A shape ``_int_mm`` cannot take on the card raises.
* The stem and embed convs are int8 convs on kernel K6
  (``ops/conv_int8.py``): the embed conv in K6's f32 mode, the BN-folded
  stem convs in its block mode with no residual and an f32 output (dequant,
  bias and relu in the kernel), the ``conv_gn`` stem's convs in the f32 mode
  with the GroupNorm and relu as an f32 epilogue in torch ops
  (quantize_vit.py:63-73). Each conv's output is quantized at the next
  conv's input scale (``quant_to``).
* The input quantize folds ``/255`` into the first layer's input scale
  (``inv / 255`` for uint8 input, quantize_vit.py:237-242); int8 input is
  taken as already quantized. ``input_lut`` holds the 256 int8 values of
  that quantize on the bytes 0..255, formed once, so the predicts gather
  int8 patches through K1's int8 mode in the ``hwc`` layout
  (:meth:`QuantizedViT.input_layout`), as they do for the int8 ResNet.
* LayerNorm (f32 statistics, eps 1e-6), the tanh GELU, the bf16 residual
  stream and the head stay torch ops; attention runs on kernel K3 on the
  card from ``models.vit.FLASH_MIN_SEQ`` tokens up, else the plain
  (jnp-branch) attention, as the float ViT dispatches it.

Scales follow the ResNet's PTQ (``models/quantize.py``): ``s_w =
max(max|w|, 1e-12)/127`` per output channel, ``s_x = max(absmax, 1e-12)/127``
as a Python float, ``dequant = s_w·f32(s_x)`` and ``in_inv_scale =
f32(1/s_x)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_plain
from ..ops.conv_int8 import conv_f32, conv_int8_block, quant_to
from . import vit as vit_module
from .quantize import QConv, fold_conv_bn
from .resnet import same_pads
from .vit import RegViT, ViT, _attention

LN_EPS = 1e-6  # flax.linen.LayerNorm's default, the ViT's blocks
GN_EPS = 1e-6  # flax nn.GroupNorm's default, the conv_gn stem

# ``torch._int_mm``'s shape rules on CUDA: more than 16 rows, K and N
# multiples of 8
_INT_MM_MIN_ROWS, _INT_MM_ALIGN = 17, 8


def int8_matmul_ref(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: the float64 product of the
    integer values, cast to int32 (exact)."""
    return (x8.double() @ w8.double().t()).round().to(torch.int32)


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (N, K) int8 → (M, N) int32, ``x8 @ w8.T``. CPU tensors
    take :func:`int8_matmul_ref`; CUDA tensors call ``torch._int_mm`` and
    raise on a shape it does not take (M ≤ 16, K or N not a multiple of 8)."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 or x8.ndim != 2 or w8.ndim != 2 \
            or x8.shape[1] != w8.shape[1]:
        raise ValueError(f"int8_matmul takes (M, K) and (N, K) int8, got "
                         f"{tuple(x8.shape)} {x8.dtype} and {tuple(w8.shape)} {w8.dtype}")
    if x8.device.type == "cpu":
        return int8_matmul_ref(x8, w8)
    m, k = x8.shape
    n = w8.shape[0]
    if m < _INT_MM_MIN_ROWS or k % _INT_MM_ALIGN or n % _INT_MM_ALIGN:
        raise ValueError(f"torch._int_mm needs M > 16 and K, N multiples of 8, got M={m}, "
                         f"K={k}, N={n}")
    return torch._int_mm(x8.contiguous(), w8.t())


def _layer_norm(x: torch.Tensor, scale, bias) -> torch.Tensor:
    """The quantized model's LayerNorm (quantize_vit.py:35-42): f32 statistics
    over the last axis, eps 1e-6, the f32 affine; the result stays f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return y * scale + bias


def _group_norm(x: torch.Tensor, scale, bias, groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """flax ``nn.GroupNorm``'s inference math in f32 on NHWC (quantize_vit.py:
    63-73): per-sample statistics over (H, W, the group's channels)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h, w, groups, c // groups)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(b, h, w, c) * scale + bias


def _n_stem_convs(model) -> int:
    return model.patch.bit_length() - 1 if model.stem in ("conv", "conv_gn") else 0


def _conv_nhwc(x, w, stride: int, padding) -> torch.Tensor:
    """f32 NHWC conv of an OIHW kernel; ``padding`` "SAME" (XLA's) or
    "VALID"."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        k = w.shape[2]
        (pt, pb), (pl, pr) = same_pads(xc.shape[2], k, stride), same_pads(xc.shape[3], k, stride)
        xc = F.pad(xc, (pl, pr, pt, pb))
    return F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)


def _folded_stem(model: ViT) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each conv-stem BN folded into its bias-free 3×3/2 conv (OIHW, f32;
    quantize_vit.py:76-93); empty for the other stems."""
    if model.stem != "conv":
        return []
    return [fold_conv_bn(getattr(model, f"stem_conv{i}").weight, getattr(model, f"stem_bn{i}"))
            for i in range(_n_stem_convs(model))]


@torch.no_grad()
def _float_forward(model: ViT, x, record: dict | None = None) -> torch.Tensor:
    """The float32 forward of ``model`` at inference (quantize_vit.py:96-179),
    BN folded for the conv stem, recording each matmul input's absmax into
    ``record`` (the calibration pass). x: (B, H, W, 3) float in [0, 1]."""

    def note(name, t):
        if record is not None:
            record[name] = max(record.get(name, 0.0), float(t.abs().max()))

    def f32(t):
        return t.detach().float()

    x = x.float()
    if model.stem == "conv":
        for i, (w, b) in enumerate(_folded_stem(model)):
            note(f"stem{i}", x)
            x = torch.relu(_conv_nhwc(x, w, 2, "SAME") + b)
    elif model.stem == "conv_gn":
        for i in range(_n_stem_convs(model)):
            note(f"stem{i}", x)
            x = _conv_nhwc(x, f32(getattr(model, f"stem_conv{i}").weight), 2, "SAME")
            gn = getattr(model, f"stem_gn{i}")
            x = torch.relu(_group_norm(x, f32(gn.weight), f32(gn.bias),
                                       groups=math.gcd(32, x.shape[-1])))
    note("embed", x)
    stride = 1 if model.stem in ("conv", "conv_gn") else model.patch
    x = _conv_nhwc(x, f32(model.embed.weight), stride, "VALID") + f32(model.embed.bias)
    b, gh, gw, d = x.shape
    n = gh * gw
    x = x.reshape(b, n, d) + f32(model.pos_embed)
    dh = model.dim // model.heads
    for i in range(model.depth):
        blk = getattr(model, f"block{i}")
        y = _layer_norm(x, f32(blk.ln1.weight), f32(blk.ln1.bias))
        note(f"block{i}/qkv", y)
        qkv = F.linear(y, f32(blk.attn.qkv.weight), f32(blk.attn.qkv.bias))
        q, k, v = qkv.reshape(b, n, 3, model.heads, dh).permute(2, 0, 3, 1, 4)
        att = attention_plain(q, k, v).transpose(1, 2).reshape(b, n, model.dim)
        note(f"block{i}/proj", att)
        x = x + F.linear(att, f32(blk.attn.proj.weight), f32(blk.attn.proj.bias))
        y = _layer_norm(x, f32(blk.ln2.weight), f32(blk.ln2.bias))
        note(f"block{i}/fc1", y)
        y = F.gelu(F.linear(y, f32(blk.fc1.weight), f32(blk.fc1.bias)), approximate="tanh")
        note(f"block{i}/fc2", y)
        x = x + F.linear(y, f32(blk.fc2.weight), f32(blk.fc2.bias))
    x = _layer_norm(x, f32(model.ln.weight), f32(model.ln.bias))
    return F.linear(x.mean(dim=1), f32(model.head.weight), f32(model.head.bias))


def _refuse_unknown(model: ViT) -> None:
    """Raise for a ViT whose parts this PTQ has no int8 form of (the UNI2-h
    :class:`~.vit.RegViT`), rather than quantize a model it does not
    compute."""
    if isinstance(model, RegViT):
        raise ValueError(
            "quantize_vit knows the GELU-MLP ViT only: it has no int8 form of the gated "
            "(SwiGLU) MLP, LayerScale, or the class and register tokens of this "
            f"{type(model).__name__}; serve it in bf16 (int8=False)"
        )


@torch.no_grad()
def calibrate_vit(model: ViT, batches) -> dict[str, float]:
    """{matmul name: input absmax} over calibration batches ((B, H, W, 3)
    float arrays in [0, 1]; quantize_vit.py:182), on the model's device.
    Refuses a ViT it cannot quantize (:class:`~.vit.RegViT`)."""
    _refuse_unknown(model)
    dev = model.pos_embed.device
    absmax: dict[str, float] = {}
    for batch in batches:
        _float_forward(model, torch.as_tensor(batch, dtype=torch.float32).to(dev), absmax)
    return absmax


class QDense(nn.Module):
    """One quantized Dense layer's buffers: ``kernel_q`` (N, K) int8 (the
    JAX package's (K, N) kernel transposed once), ``dequant`` (N,) f32,
    ``bias`` (N,) f32 and ``in_inv_scale`` () f32."""

    def __init__(self, kernel_q, dequant, bias, in_inv_scale):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q.to(torch.int8).contiguous())
        self.register_buffer("dequant", dequant.to(torch.float32).contiguous())
        self.register_buffer("bias", bias.to(torch.float32).contiguous())
        self.register_buffer("in_inv_scale", torch.as_tensor(in_inv_scale, dtype=torch.float32))

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        """The int8 Dense with its f32 epilogue (quantize_vit.py:226-234):
        ``xf`` quantized at the input scale, the s8 product, then
        ``y·dequant + bias``, each rounded on its own."""
        lead, k = xf.shape[:-1], xf.shape[-1]
        x8 = quant_to(xf, self.in_inv_scale).reshape(-1, k)
        y = int8_matmul(x8, self.kernel_q)
        return (y.float() * self.dequant + self.bias).reshape(*lead, -1)


def _f32_buffer(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32, memory_format=torch.contiguous_format,
                                          copy=True)


class QuantizedViT(nn.Module):
    """int8 ViT built from a float :class:`~.vit.ViT`'s shape and a dict of
    quantized parameters (:func:`quantize_vit`, or
    ``convert.flax_vit_qvariables_to_torch`` for the JAX package's
    ``qvariables``), with the JAX package's names: ``embed``, ``stem{i}``
    (convs: ``kernel_q`` (Cout, KH, KW, Cin) int8, ``dequant``, ``bias``,
    ``in_inv_scale``), ``stem_gn{i}`` (``scale``, ``bias``), ``pos_embed``,
    ``block{i}`` (``ln1``, ``ln2``: ``scale``, ``bias``), ``block{i}/qkv``,
    ``/proj``, ``/fc1``, ``/fc2`` (Dense: ``kernel_q`` (N, K) int8, ...),
    ``ln`` and ``head`` (``kernel`` (in, out), ``bias``). Inference only;
    every tensor is a buffer, on the device the parameters were given on."""

    wants_uint8 = True

    def __init__(self, model: ViT, qparams: dict):
        super().__init__()
        self.stem, self.patch, self.dim = model.stem, model.patch, model.dim
        self.depth, self.heads = model.depth, model.heads
        self.n_convs = _n_stem_convs(model)
        conv_names = [f"stem{i}" for i in range(self.n_convs)] + ["embed"]
        self.convs = nn.ModuleDict({n: QConv(**qparams[n]) for n in conv_names})
        self.dense = nn.ModuleDict({
            f"block{i}__{m}": QDense(**qparams[f"block{i}/{m}"])
            for i in range(self.depth) for m in ("qkv", "proj", "fc1", "fc2")
        })
        self.register_buffer("pos_embed", _f32_buffer(qparams["pos_embed"]))
        norms = {"ln": qparams["ln"]}
        for i in range(self.depth):
            norms |= {f"block{i}__ln1": qparams[f"block{i}"]["ln1"],
                      f"block{i}__ln2": qparams[f"block{i}"]["ln2"]}
        if self.stem == "conv_gn":
            norms |= {f"stem_gn{i}": qparams[f"stem_gn{i}"] for i in range(self.n_convs)}
        for name, p in norms.items():
            self.register_buffer(f"{name}__scale", _f32_buffer(p["scale"]))
            self.register_buffer(f"{name}__bias", _f32_buffer(p["bias"]))
        self.register_buffer("head_kernel", _f32_buffer(qparams["head"]["kernel"]))
        self.register_buffer("head_bias", _f32_buffer(qparams["head"]["bias"]))
        first = self.convs[conv_names[0]].in_inv_scale
        self.register_buffer("input_lut", self.quantize_input(
            torch.arange(256, dtype=torch.uint8, device=first.device)), persistent=False)

    def _first(self) -> QConv:
        return self.convs["stem0" if self.n_convs else "embed"]

    def _norm(self, name: str):
        return getattr(self, f"{name}__scale"), getattr(self, f"{name}__bias")

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """The first conv's input quantize (quantize_vit.py:237-243): int8
        passes through (pre-quantized), uint8 takes ``round(u8·(inv/255))``,
        a float input (already /255) ``round(x·inv)``, clipped to ±127."""
        if x.dtype == torch.int8:
            return x
        inv = self._first().in_inv_scale.to(x.device)
        return quant_to(x, inv / 255.0 if x.dtype == torch.uint8 else inv)

    def input_layout(self, packed: bool | str = False) -> tuple[str, bool]:
        """(K1 int8 layout, ``pre_packed``) of a batch of windows gathered
        from a raw slide: ``("hwc", False)``; the ViT takes no packed
        input."""
        if packed:
            raise ValueError("the ViT takes no s2d-packed input")
        return "hwc", False

    def _conv(self, name: str, x8: torch.Tensor, stride: int, padding: str, relu: bool):
        layer = self.convs[name]
        k = layer.kernel_q.shape[1]
        if padding == "SAME":
            pads = same_pads(x8.shape[1], k, stride), same_pads(x8.shape[2], k, stride)
        else:
            pads = ((0, 0), (0, 0))
        if relu:  # dequant + bias + relu in K6's block mode
            return conv_int8_block(x8, layer.kernel_q, stride, pads, layer.dequant, layer.bias,
                                   None, "none", None, None, "f32")
        return conv_f32(x8, layer.kernel_q, stride, pads, layer.dequant, layer.bias)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 stem and embed convs: (B, H, W, 3) uint8/int8/float →
        (B, gh, gw, dim) f32 (the embed conv's output, before ``pos_embed``)."""
        x8 = self.quantize_input(x).contiguous()
        for i in range(self.n_convs):
            if self.stem == "conv_gn":
                scale, bias = self._norm(f"stem_gn{i}")
                y = self._conv(f"stem{i}", x8, 2, "SAME", relu=False)
                y = torch.relu(_group_norm(y, scale, bias, groups=math.gcd(32, y.shape[-1])))
            else:
                y = self._conv(f"stem{i}", x8, 2, "SAME", relu=True)
            nxt = f"stem{i + 1}" if i + 1 < self.n_convs else "embed"
            x8 = quant_to(y, self.convs[nxt].in_inv_scale)
        stride = 1 if self.n_convs else self.patch
        return self._conv("embed", x8, stride, "VALID", relu=False)

    @torch.no_grad()
    def forward(self, x):
        """x: (B, H, W, 3) uint8 (/255 folded into the input scale), int8
        (already quantized, as K1's int8 mode gathers it) or float in [0,
        1]. Returns (B, n_classes) f32 logits."""
        xe = self.embed(x)
        b, gh, gw, d = xe.shape
        n = gh * gw
        x = (xe.reshape(b, n, d) + self.pos_embed).to(torch.bfloat16)
        dh = self.dim // self.heads
        for i in range(self.depth):
            y = _layer_norm(x, *self._norm(f"block{i}__ln1"))
            qkv = self.dense[f"block{i}__qkv"](y).to(torch.bfloat16)
            qkv = qkv.reshape(b, n, 3, self.heads, dh)
            att = _attention(qkv, use_flash=vit_module.use_flash(qkv))
            att = att.transpose(1, 2).reshape(b, n, self.dim)
            x = x + self.dense[f"block{i}__proj"](att).to(torch.bfloat16)
            y = _layer_norm(x, *self._norm(f"block{i}__ln2"))
            y = F.gelu(self.dense[f"block{i}__fc1"](y), approximate="tanh")
            x = x + self.dense[f"block{i}__fc2"](y).to(torch.bfloat16)
        f = _layer_norm(x, *self._norm("ln")).mean(dim=1)
        return f @ self.head_kernel + self.head_bias


def _qweights(w: torch.Tensor, bias: torch.Tensor, absmax: float, conv: bool) -> dict:
    """int8 weights at per-output-channel scales and the epilogue constants
    (quantize_vit.py:303-314); ``w`` OIHW (conv) or (out, in) (Dense), f32."""
    dims = tuple(range(1, w.ndim))
    s_w = torch.clamp(w.abs().amax(dim=dims), min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / s_w.view(-1, *([1] * len(dims)))), -127, 127)
    s_x = max(absmax, 1e-12) / 127.0  # a Python float, as in JAX
    w_q = w_q.to(torch.int8)
    return {
        "kernel_q": w_q.permute(0, 2, 3, 1) if conv else w_q,  # OIHW → (Cout, KH, KW, Cin)
        "dequant": s_w * torch.tensor(s_x, dtype=torch.float32, device=w.device),
        "bias": bias.float(),
        "in_inv_scale": torch.tensor(1.0 / s_x, dtype=torch.float32, device=w.device),
    }


@torch.no_grad()
def quantize_vit(model: ViT, calib_batches) -> QuantizedViT:
    """Post-training-quantize a float :class:`~.vit.ViT` (quantize_vit.py:
    297): ``calib_batches`` is an iterable of (B, H, W, 3) float arrays in
    [0, 1]. Returns the :class:`QuantizedViT`, on the model's device.
    Refuses a gated-MLP, LayerScale or register-token ViT (ValueError)."""
    _refuse_unknown(model)
    absmax = calibrate_vit(model, calib_batches)

    def f32(t):
        return t.detach().float()

    def qw(name, w, b, conv):
        return _qweights(f32(w), f32(b), absmax.get(name, 1.0), conv)

    qp: dict = {"embed": qw("embed", model.embed.weight, model.embed.bias, True),
                "pos_embed": f32(model.pos_embed)}
    for i, (w, b) in enumerate(_folded_stem(model)):
        qp[f"stem{i}"] = qw(f"stem{i}", w, b, True)
    if model.stem == "conv_gn":
        for i in range(_n_stem_convs(model)):
            w = getattr(model, f"stem_conv{i}").weight
            qp[f"stem{i}"] = qw(f"stem{i}", w, torch.zeros(w.shape[0], device=w.device), True)
            gn = getattr(model, f"stem_gn{i}")
            qp[f"stem_gn{i}"] = {"scale": f32(gn.weight), "bias": f32(gn.bias)}
    qp["ln"] = {"scale": f32(model.ln.weight), "bias": f32(model.ln.bias)}
    qp["head"] = {"kernel": f32(model.head.weight).t(), "bias": f32(model.head.bias)}
    for i in range(model.depth):
        blk = getattr(model, f"block{i}")
        qp[f"block{i}"] = {"ln1": {"scale": f32(blk.ln1.weight), "bias": f32(blk.ln1.bias)},
                           "ln2": {"scale": f32(blk.ln2.weight), "bias": f32(blk.ln2.bias)}}
        for name, layer in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj), ("fc1", blk.fc1),
                            ("fc2", blk.fc2)):
            qp[f"block{i}/{name}"] = qw(f"block{i}/{name}", layer.weight, layer.bias, False)
    return QuantizedViT(model, qp)
