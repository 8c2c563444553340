"""Post-training int8 quantization of the ResNet family, a port of
``deephisto_tpu/models/quantize.py``.

* BatchNorm folds into the conv before it (:func:`fold_conv_bn`): ``w' = w·γ
  ·rsqrt(σ²+ε)``, ``b' = β − μ·γ·rsqrt(σ²+ε)``.
* Weights are int8 per output channel (``s_w = max|w'|/127``); activations
  int8 per tensor at the scale a float forward over calibration batches
  records (:func:`calibrate`, ``s_x = absmax/127``).
* :class:`QuantizedResNet` runs every conv as an s8 × s8 → s32 convolution
  with its f32 epilogue, kernel K6 (``ops/conv_int8.py``): dequant + bias
  (the downsample), dequant + bias + relu + requant to the next conv's input
  scale (a block's inner convs), or, for a block's last conv and the s2d
  stem, the whole block epilogue in the conv: dequant + bias, the residual
  added (the bf16 carry, the downsample's f32 output or the dequantized
  int8 input), relu, and the bf16 carry and the next conv's int8 input
  written, as the JAX package's comment has XLA fuse it (quantize.py:387).
  The block whose output is kept (the last, or where ``up_to`` stops)
  writes it in f32. The imagenet stem's max pool, the GAP and the fc head
  stay torch ops.

The JAX package's ``pack_l1`` (stage 1 on 2×2 space-to-depth data) and its
``pre_packed="s2d8"`` stem are TPU lane layouts that it documents as bit
identical to the unpacked trunk (quantize.py:193-198). The port takes both
as math, not as layout: ``pack_l1=True`` is accepted (and checked as the JAX
package checks it), an ``"s2d8"`` input goes back to the 4×4 form with one
reshape, and the unpacked trunk runs. ``_pack_a``, ``_edge_masks_a`` and
``_embed_kernel`` are not ported.

Numerics follow the JAX package: every scale and epilogue constant is f32
(``inv0 / 255``, ``dequant·inv``, ``bias·inv``, ``1 / inv``); ``s_x`` and
``1 / s_x`` are taken in float64 from the f32 absmax and rounded to f32 as
Python floats are there; ``jnp.round`` is half to even, as ``torch.round``;
with ``int8_residual=False`` block outputs are carried in bf16. The
requant constants ``dequant·inv`` and ``bias·inv`` and each conv's ``s_x =
1 / inv`` are formed once, when the model is built, as the same f32
operations the JAX package runs per call; they stay on the model's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_int8 import conv_f32, conv_int8_block, conv_to_int8, quant_to
from ..ops.gather import s2d_pack4, unpack_s2d8
from .resnet import BasicBlock, ResNet, same_pads

EPS = 1e-5  # BatchNorm epsilon (resnet.py BatchNorm)
UP_TO = ("quant", "stem", "l1", "l2_entry", "layer2", "layer3", "layer4")


# ---------------------------------------------------------------------------
# BN folding and the topology walk
# ---------------------------------------------------------------------------


def fold_conv_bn(weight: torch.Tensor, bn: nn.BatchNorm2d):
    """Fold inference BatchNorm ``bn`` into a bias-free conv ``weight``
    (OIHW). Returns (w_folded, b_folded), f32, with ``BN(conv(x, w)) ==
    conv(x, w_folded) + b_folded``."""
    mult = bn.weight.float() * torch.rsqrt(bn.running_var.float() + EPS)
    w = weight.float() * mult[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * mult
    return w, b


def _blocks(model) -> tuple[bool, list[tuple[str, int]]]:
    """(basic, [(block name, stride), ...]) in execution order
    (quantize.py:74-86)."""
    basic = getattr(model, "basic", None)
    if basic is None:
        first = getattr(model, "layer1_0")
        basic = isinstance(first, BasicBlock)
    blocks = []
    for i, count in enumerate(model.stage_sizes):
        for j in range(count):
            blocks.append((f"layer{i + 1}_{j}", 2 if i > 0 and j == 0 else 1))
    return basic, blocks


def _conv_names(model) -> list[str]:
    """Every conv in execution order, as the JAX package names them."""
    basic, blocks = _blocks(model)
    names = ["conv1"]
    for name, _ in blocks:
        block = getattr(model, name)
        for ci in ("conv1", "conv2", "conv3"):
            if hasattr(block, ci):
                names.append(f"{name}/{ci}")
        if block.has_downsample:
            names.append(f"{name}/downsample_conv")
    return names


@torch.no_grad()
def _folded_params(model: ResNet) -> dict:
    """name → (w_folded OIHW f32, b_folded f32) for every conv, plus
    ``"fc"`` → (kernel (in, out), bias), all f32 (quantize.py:133)."""
    out = {"conv1": fold_conv_bn(model.conv1.weight, model.bn1)}
    for name in _conv_names(model)[1:]:
        block, ci = name.split("/")
        block = getattr(model, block)
        bn = "downsample_bn" if ci == "downsample_conv" else "bn" + ci[-1]
        out[name] = fold_conv_bn(getattr(block, ci).weight, getattr(block, bn))
    out["fc"] = (model.fc.weight.detach().float().t(), model.fc.bias.detach().float())
    return out


def _stem(model, x, conv_apply):
    """The stem (resnet.py) with the given conv executor; NHWC."""
    if model.stem == "s2d":
        x = s2d_pack4(x)
        return conv_apply("conv1", x, 1, True)
    x = conv_apply("conv1", x, 2, True, ((3, 3), (3, 3)))
    return max_pool(x)


def _trunk(model, x, conv_apply, add_relu):
    basic, blocks = _blocks(model)
    for name, stride in blocks:
        residual = x
        if basic:
            y = conv_apply(f"{name}/conv1", x, stride, True)
            y = conv_apply(f"{name}/conv2", y, 1, False)
        else:
            y = conv_apply(f"{name}/conv1", x, 1, True)
            y = conv_apply(f"{name}/conv2", y, stride, True)
            y = conv_apply(f"{name}/conv3", y, 1, False)
        if y.shape != residual.shape:
            residual = conv_apply(f"{name}/downsample_conv", x, stride, False)
        x = add_relu(residual, y)
    return x


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 / 2 max pool padded (1, 1) on NHWC (quantize.py:102-111): −inf
    padding for floats, −128 for int8."""
    xc = x.permute(0, 3, 1, 2)
    if x.dtype == torch.int8:
        y = F.max_pool2d(F.pad(xc.float(), (1, 1, 1, 1), value=-128.0), 3, 2).to(torch.int8)
    else:
        y = F.max_pool2d(xc, 3, 2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _same(x, k: int, stride: int):
    return same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)


def _conv_float(x, w, b, stride, padding=None):
    """f32 NHWC conv of the folded weights (OIHW), flax SAME padding unless
    ``padding`` gives it."""
    k = w.shape[2]
    (pt, pb), (pl, pr) = padding or _same(x, k, stride)
    xc = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    return (F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1) + b).contiguous()


@torch.no_grad()
def folded_float_apply(model: ResNet, x) -> torch.Tensor:
    """Float forward on the BN-folded weights (the reference the int8 path
    approximates, and the exactness check of BN folding)."""
    folded = _folded_params(model)

    def conv_apply(name, x, stride, relu, padding=None):
        w, b = folded[name]
        y = _conv_float(x, w, b, stride, padding)
        return torch.relu(y) if relu else y

    x = torch.as_tensor(x, dtype=torch.float32)
    x = _stem(model, x, conv_apply)
    x = _trunk(model, x, conv_apply, lambda r, y: torch.relu(r + y))
    wfc, bfc = folded["fc"]
    return x.mean(dim=(1, 2)) @ wfc + bfc


@torch.no_grad()
def calibrate(model: ResNet, batches) -> dict[str, float]:
    """Per-conv-input absmax over calibration batches: (B, H, W, 3) float
    arrays in [0, 1]. Returns {conv name: float absmax}."""
    folded = _folded_params(model)
    dev = folded["conv1"][0].device
    absmax: dict[str, float] = {}

    def conv_apply(name, x, stride, relu, padding=None):
        absmax[name] = max(absmax.get(name, 0.0), float(x.abs().max()))
        w, b = folded[name]
        y = _conv_float(x, w, b, stride, padding)
        return torch.relu(y) if relu else y

    for batch in batches:
        x = torch.as_tensor(batch, dtype=torch.float32).to(dev)
        x = _stem(model, x, conv_apply)
        _trunk(model, x, conv_apply, lambda r, y: torch.relu(r + y))
    return absmax


# ---------------------------------------------------------------------------
# int8 model
# ---------------------------------------------------------------------------


def supports_pack_l1(model) -> bool:
    """Whether ``pack_l1`` applies: a BasicBlock ResNet with >= 2 stages
    (quantize.py:351)."""
    basic, _ = _blocks(model)
    return basic and len(model.stage_sizes) >= 2


class QConv(nn.Module):
    """One quantized conv's buffers: ``kernel_q`` (Cout, KH, KW, Cin) int8,
    ``dequant`` (Cout,) f32 (``s_w·s_x``), ``bias`` (Cout,) f32 (the folded
    bias) and ``in_inv_scale`` () f32 (``1/s_x``)."""

    def __init__(self, kernel_q, dequant, bias, in_inv_scale):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q.to(torch.int8).contiguous())
        self.register_buffer("dequant", dequant.to(torch.float32).contiguous())
        self.register_buffer("bias", bias.to(torch.float32).contiguous())
        self.register_buffer("in_inv_scale", torch.as_tensor(in_inv_scale, dtype=torch.float32))
        # s_x, the dequant of an int8 residual (quantize.py:647), formed once
        self.register_buffer("in_scale", 1.0 / self.in_inv_scale, persistent=False)

    def requant_to(self, nxt: "QConv") -> None:
        """Form ``dequant·inv`` and ``bias·inv`` (``inv`` the next conv's
        input scale, quantize.py:477-479) once: the constants of this conv's
        int8 mode (``req_a``, ``req_b``)."""
        self.register_buffer("req_a", self.dequant * nxt.in_inv_scale, persistent=False)
        self.register_buffer("req_b", self.bias * nxt.in_inv_scale, persistent=False)


class QuantizedResNet(nn.Module):
    """int8 ResNet built from a float :class:`ResNet`'s topology and a dict
    of quantized parameters (:func:`quantize_resnet`, or
    ``convert.flax_qvariables_to_torch`` for the JAX package's
    ``qvariables``).

    ``qparams``: {conv name ("conv1", "layer1_0/conv1", ...): {"kernel_q",
    "dequant", "bias", "in_inv_scale"}, "fc": {"kernel" (in, out), "bias"}}.

    ``int8_residual`` selects the residual stream's precision as in the JAX
    package: False carries block outputs in bf16 and quantizes them at each
    block input; True keeps the trunk int8 and adds the dequantized int8.

    ``wants_uint8``: the predicts hand it raw uint8 patches, whose /255
    folds into conv1's input scale. ``input_lut`` holds the 256 int8 values
    of :meth:`quantize_input` on the bytes 0..255, formed once: the predicts
    gather int8 patches through it in K1's int8 mode
    (``ops/gather.py:gather_quantize_int8``) and hand them over quantized,
    in the layout :meth:`input_layout` names."""

    wants_uint8 = True

    def __init__(self, model: ResNet, qparams: dict, int8_residual: bool = False,
                 pack_l1: bool = False):
        super().__init__()
        self.stem = model.stem
        self.stage_sizes = tuple(model.stage_sizes)
        self.basic, self._block_list = _blocks(model)
        self.int8_residual = int8_residual
        self.pack_l1 = pack_l1
        if pack_l1 and not supports_pack_l1(model):
            raise ValueError(
                "pack_l1 requires a BasicBlock ResNet with >=2 stages "
                "(the packed chain exits through the stage-2 entry convs)"
            )
        self.convs = nn.ModuleDict({
            name.replace("/", "__"): QConv(**p) for name, p in qparams.items() if name != "fc"
        })
        for name, nxt in self._requant_edges():
            self.q(name).requant_to(self.q(nxt))
        # the input quantize of every byte value, as quantize_input runs it
        inv0 = self.q("conv1").in_inv_scale
        self.register_buffer("input_lut", self.quantize_input(
            torch.arange(256, dtype=torch.uint8, device=inv0.device)), persistent=False)
        # copies: the folded fc may share storage with the float model's
        for name, key in (("fc_kernel", "kernel"), ("fc_bias", "bias")):
            self.register_buffer(name, qparams["fc"][key].to(
                torch.float32, memory_format=torch.contiguous_format, copy=True))

    def q(self, name: str) -> QConv:
        return self.convs[name.replace("/", "__")]

    def _requant_edges(self) -> list[tuple[str, str]]:
        """(conv, next conv) of every int8-mode conv of :meth:`forward`."""
        edges = [("conv1", f"{self._block_list[0][0]}/conv1")]
        inner = ("conv1", "conv2") if self.basic else ("conv1", "conv2", "conv3")
        for name, _ in self._block_list:
            edges += [(f"{name}/{a}", f"{name}/{b}") for a, b in zip(inner, inner[1:])]
        return edges

    def _conv_f32(self, name, x8, stride, padding=None):
        layer = self.q(name)
        k = layer.kernel_q.shape[1]
        return conv_f32(x8, layer.kernel_q, stride, padding or _same(x8, k, stride),
                        layer.dequant, layer.bias)

    def _conv_to_int8(self, name, x8, stride, padding=None):
        """The int8 mode at the constants :meth:`QConv.requant_to` formed."""
        layer = self.q(name)
        k = layer.kernel_q.shape[1]
        return conv_to_int8(x8, layer.kernel_q, stride, padding or _same(x8, k, stride),
                            layer.req_a, layer.req_b)

    def _conv_block(self, name, x8, stride, residual, res_kind, res_scale, next_name, out):
        """The block mode of K6 (``ops/conv_int8.py:conv_int8_block``): conv
        ``name`` with the block epilogue; ``next_name``'s input scale for
        the int8 output."""
        layer = self.q(name)
        k = layer.kernel_q.shape[1]
        inv = None if next_name is None else self.q(next_name).in_inv_scale
        return conv_int8_block(x8, layer.kernel_q, stride, _same(x8, k, stride), layer.dequant,
                               layer.bias, residual, res_kind, res_scale, inv, out)

    def _quant_to(self, name, xf):
        return quant_to(xf, self.q(name).in_inv_scale)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's input quantize (quantize.py:483-500): int8 passes
        through (pre-quantized), uint8 takes ``round(u8·(inv0/255))``, a
        float input (already /255) ``round(x·inv0)``, clipped to ±127."""
        if x.dtype == torch.int8:
            return x
        inv0 = self.q("conv1").in_inv_scale.to(x.device)
        scale = inv0 / 255.0 if x.dtype == torch.uint8 else inv0
        return torch.clamp(torch.round(x.float() * scale), -127, 127).to(torch.int8)

    def input_layout(self, packed: bool | str = False) -> tuple[str, bool | str]:
        """(K1 int8 layout, ``pre_packed`` for :meth:`forward`) of a batch of
        windows gathered from a raw slide (``packed=False``), a 4×4 packed
        one (True) or an "s2d8" one ("s2d8"): the s2d stem takes the 4×4
        form, so every int8 batch reaches it packed."""
        if packed and self.stem != "s2d":
            raise ValueError("packed input requires the s2d stem")
        if packed == "s2d8":
            return "s2d8_to_s2d4", True
        if packed:
            return "hwc", True
        return ("s2d4", True) if self.stem == "s2d" else ("hwc", False)

    @torch.no_grad()
    def forward(self, x, features: bool = False, pre_packed: bool | str = False,
                up_to: str | None = None):
        """x: (B, H, W, 3) uint8/int8/float, or with ``pre_packed=True`` the
        4×4 s2d form (B, H/4, W/4, 48), or with ``"s2d8"`` the 8×8 form
        (B, H/8, W/8, 192; pack_l1 models only). Returns (B, n_classes) f32
        logits, or with ``features=True`` the bf16 stride-32 feature map.

        ``up_to`` returns the live tensor at a boundary (dtype as run):
        "quant" (input int8), "stem", "l1", "l2_entry" (after stage 2's
        first block), "layer2", "layer3", "layer4". The port's pack_l1 trunk
        is the unpacked one, so its "l1" is the unpacked tensor, where the
        JAX package returns its pack_A layout."""
        if up_to is not None and up_to not in UP_TO:
            raise ValueError(f"up_to must be one of {UP_TO}, got {up_to!r}")
        if pre_packed and self.stem != "s2d":
            raise ValueError("pre_packed input requires the s2d stem")
        if pre_packed == "s2d8" and not self.pack_l1:
            raise ValueError("pre_packed='s2d8' requires pack_l1=True")
        blocks = self._block_list
        x8 = self.quantize_input(x)
        if up_to == "quant":
            return x8

        # ---- stem ---------------------------------------------------------
        first_block_in = f"{blocks[0][0]}/conv1"
        x_bf = None
        if self.stem == "s2d":
            if pre_packed == "s2d8":
                x8 = unpack_s2d8(x8)
            elif not pre_packed:
                x8 = s2d_pack4(x8)
            x8 = x8.contiguous()
            if self.int8_residual:
                x8 = self._conv_to_int8("conv1", x8, 1)
            else:  # relu, the bf16 carry and the block input in K6
                x_bf, x8 = self._conv_block("conv1", x8, 1, None, "none", None,
                                            first_block_in, "carry")
        else:
            stem_pad = ((3, 3), (3, 3))
            if self.int8_residual:
                x8 = max_pool(self._conv_to_int8("conv1", x8, 2, stem_pad))  # monotone
            else:  # the max pool follows the relu: torch ops
                x_f = max_pool(torch.relu(self._conv_f32("conv1", x8, 2, stem_pad)))
                x_bf = x_f.to(torch.bfloat16)
                x8 = self._quant_to(first_block_in, x_bf)
        if self.pack_l1 and pre_packed != "s2d8" and (x8.shape[1] % 2 or x8.shape[2] % 2):
            raise ValueError(
                f"pack_l1 needs an even stage-1 spatial extent, got {tuple(x8.shape[1:3])} "
                "(input height/width must be multiples of 8)"
            )
        if up_to == "stem":
            return x8 if x_bf is None else x_bf

        # ---- residual stages: each block's last conv carries its epilogue --
        n1 = self.stage_sizes[0]
        last = "conv2" if self.basic else "conv3"
        out_f = None
        for bi, (name, stride) in enumerate(blocks):
            if self.basic:
                h8 = self._conv_to_int8(f"{name}/conv1", x8, stride)
            else:
                h8 = self._conv_to_int8(f"{name}/conv1", x8, 1)
                h8 = self._conv_to_int8(f"{name}/conv2", h8, stride)
            res_scale = None
            if f"{name}__downsample_conv" in self.convs:
                # same input tensor as conv1 → same calibrated scale: reuse x8
                residual, res_kind = self._conv_f32(f"{name}/downsample_conv", x8, stride), "f32"
            elif self.int8_residual:
                residual, res_kind = x8, "int8"
                res_scale = self.q(f"{name}/conv1").in_scale
            else:
                residual, res_kind = x_bf, "bf16"
            stage = name.split("_")[0]
            stage_done = bi + 1 == len(blocks) or not blocks[bi + 1][0].startswith(stage + "_")
            stop = (stage_done and up_to == {"layer1": "l1"}.get(stage, stage)) or (
                bi == n1 and up_to == "l2_entry")
            if stop or bi + 1 == len(blocks):  # the block output is kept: f32
                out_f = self._conv_block(f"{name}/{last}", h8, 1, residual, res_kind, res_scale,
                                         None, "f32")
                if stop:
                    return out_f
            else:
                nxt = f"{blocks[bi + 1][0]}/conv1"
                if self.int8_residual:
                    x8 = self._conv_block(f"{name}/{last}", h8, 1, residual, res_kind, res_scale,
                                          nxt, "int8")
                else:
                    x_bf, x8 = self._conv_block(f"{name}/{last}", h8, 1, residual, res_kind,
                                                res_scale, nxt, "carry")

        if features:
            return out_f.to(torch.bfloat16)
        f = out_f.mean(dim=(1, 2))
        return f @ self.fc_kernel + self.fc_bias


def prequantize_input(qmodel: QuantizedResNet, image) -> torch.Tensor:
    """Quantize a uint8 slide once at conv1's input scale (quantize.py:697):
    the quantize is elementwise, so it commutes with patch gathering and a
    predict from the int8 slide is bit-exact. A float input is taken as
    already /255, an int8 one as already quantized."""
    return qmodel.quantize_input(torch.as_tensor(image))


@torch.no_grad()
def quantize_resnet(model: ResNet, calib_batches, int8_residual: bool = False,
                    pack_l1: bool = False) -> QuantizedResNet:
    """Post-training-quantize a float :class:`ResNet` (quantize.py:719):
    ``calib_batches`` is an iterable of (B, H, W, 3) float arrays in [0, 1].
    Returns the :class:`QuantizedResNet`, on the float model's device."""
    return _quantize(model, _folded_params(model), calibrate(model, calib_batches),
                     int8_residual, pack_l1)


def _quantize(model, folded: dict, absmax: dict, int8_residual: bool = False,
              pack_l1: bool = False) -> QuantizedResNet:
    """The int8 model from folded float parameters (as
    :func:`_folded_params` gives them) and calibrated absmax: per-channel
    ``s_w = max|w'|/127`` and ``round(w'/s_w)``, per-tensor ``s_x =
    absmax/127`` as a Python float, ``dequant = s_w·f32(s_x)`` and
    ``in_inv_scale = f32(1/s_x)`` (quantize.py:738-760)."""
    qparams: dict = {}
    for name, (w, b) in folded.items():
        if name == "fc":
            qparams["fc"] = {"kernel": w.contiguous(), "bias": b}
            continue
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
        w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127)
        s_x = max(absmax.get(name, 1.0), 1e-12) / 127.0  # a Python float, as in JAX
        qparams[name] = {
            "kernel_q": w_q.to(torch.int8).permute(0, 2, 3, 1),  # OIHW → (Cout, KH, KW, Cin)
            "dequant": s_w * torch.tensor(s_x, dtype=torch.float32, device=w.device),
            "bias": b,
            "in_inv_scale": torch.tensor(1.0 / s_x, dtype=torch.float32, device=w.device),
        }
    return QuantizedResNet(model, qparams, int8_residual=int8_residual, pack_l1=pack_l1)
