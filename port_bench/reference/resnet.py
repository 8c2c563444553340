"""Plain reference of the ResNet patch classifier with the 4×4
space-to-depth stem (He et al., arXiv:1512.03385, BasicBlocks; TResNet's
SpaceToDepth stem, arXiv:2003.13630), NHWC, from a raw state dict of the
names ``conv1``, ``bn1``, ``layer{s}_{j}.conv{1,2}``, ``.bn{1,2}``,
``.downsample_conv``, ``.downsample_bn`` and ``fc``.

Two forwards and a feature map:

* :func:`float_forward` — the float model: SAME convs, eval BatchNorm
  (eps 1e-5), ReLU, the residual, the global mean and the linear head, in
  float32 (the patch classifier as trained; its pooled features fit the
  benchmark's head);
* :class:`QuantRef` — post-training quantization of it, worked out here
  from the raw weights: BatchNorm folded into each conv, weights per output
  channel at ``max|w|/qmax``, activations per tensor at the absmax that a
  float forward of the calibration images records, ``round`` half to even,
  the bf16 carry of each block's output; exact integer sums. ``qmax`` 127 is
  int8, 7 is int4 (the control of an int8 configuration);
* ``QuantRef.features`` — the stride-32 feature map of the same integer
  trunk (the fcn mode's input to the head).
"""

from __future__ import annotations

import torch

from .common import conv_nhwc, int_conv, s2d4

BN_EPS = 1e-5


def blocks(stage_sizes) -> list[tuple[str, int]]:
    """(block name, stride) in execution order."""
    out = []
    for i, count in enumerate(stage_sizes):
        for j in range(count):
            out.append((f"layer{i + 1}_{j}", 2 if i > 0 and j == 0 else 1))
    return out


def _bn(sd: dict, name: str):
    return (sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(),
            sd[f"{name}.running_mean"].float(), sd[f"{name}.running_var"].float())


def _has_ds(sd: dict, block: str) -> bool:
    return f"{block}.downsample_conv.weight" in sd


def float_forward(sd: dict, stage_sizes, x: torch.Tensor, pooled: bool = False):
    """float32 logits (B, classes) of (B, H, W, 3) float images in [0, 1];
    with ``pooled`` the (B, C) pooled features the head takes."""

    def conv_bn(x, conv, bn, stride):
        g, b, m, v = _bn(sd, bn)
        y = conv_nhwc(x, sd[f"{conv}.weight"].float(), stride)
        return (y - m) * (g / torch.sqrt(v + BN_EPS)) + b

    x = s2d4(x.float())
    x = torch.relu(conv_bn(x, "conv1", "bn1", 1))
    for name, stride in blocks(stage_sizes):
        y = torch.relu(conv_bn(x, f"{name}.conv1", f"{name}.bn1", stride))
        y = conv_bn(y, f"{name}.conv2", f"{name}.bn2", 1)
        r = (conv_bn(x, f"{name}.downsample_conv", f"{name}.downsample_bn", stride)
             if _has_ds(sd, name) else x)
        x = torch.relu(r + y)
    f = x.mean(dim=(1, 2))
    if pooled:
        return f
    return f @ sd["fc.weight"].float().t() + sd["fc.bias"].float()


def conv_names(sd: dict, stage_sizes) -> list[str]:
    names = ["conv1"]
    for name, _ in blocks(stage_sizes):
        names += [f"{name}.conv1", f"{name}.conv2"]
        if _has_ds(sd, name):
            names.append(f"{name}.downsample_conv")
    return names


def fold(sd: dict, stage_sizes) -> dict:
    """conv name → (BN-folded OIHW weight, bias), float32:
    ``w·γ/sqrt(σ² + eps)`` and ``β − μ·γ/sqrt(σ² + eps)``."""
    out = {}
    for conv in conv_names(sd, stage_sizes):
        bn = "bn1" if conv == "conv1" else conv.rsplit(".", 1)[0] + (
            ".downsample_bn" if conv.endswith("downsample_conv") else ".bn" + conv[-1])
        g, b, m, v = _bn(sd, bn)
        mult = g * torch.rsqrt(v + BN_EPS)
        out[conv] = (sd[f"{conv}.weight"].float() * mult[:, None, None, None], b - m * mult)
    return out


def calibrate(folded: dict, stage_sizes, batches) -> dict[str, float]:
    """Per-conv-input absmax of the folded float forward over calibration
    batches ((B, H, W, 3) float32 in [0, 1])."""
    absmax: dict[str, float] = {}

    def conv(name, x, stride, relu):
        absmax[name] = max(absmax.get(name, 0.0), float(x.abs().max()))
        w, b = folded[name]
        y = conv_nhwc(x, w, stride) + b
        return torch.relu(y) if relu else y

    for batch in batches:
        x = conv("conv1", s2d4(batch.float()), 1, True)
        for name, stride in blocks(stage_sizes):
            y = conv(f"{name}.conv1", x, stride, True)
            y = conv(f"{name}.conv2", y, 1, False)
            r = conv(f"{name}.downsample_conv", x, stride, False) if (
                f"{name}.downsample_conv" in folded) else x
            x = torch.relu(r + y)
    return absmax


class QuantRef:
    """The integer-quantized model at ``qmax`` (127: int8; 7: int4), from
    the raw state dict and the calibration batches."""

    def __init__(self, sd: dict, stage_sizes, calib_batches, qmax: int = 127, absmax=None):
        self.stage_sizes = tuple(stage_sizes)
        self.qmax = int(qmax)
        folded = fold(sd, stage_sizes)
        self.absmax = absmax if absmax is not None else calibrate(folded, stage_sizes,
                                                                  calib_batches)
        q = float(self.qmax)
        self.layers = {}
        for name, (w, b) in folded.items():
            s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / q
            wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -q, q)
            s_x = max(self.absmax.get(name, 1.0), 1e-12) / q  # a float64 scalar
            dev = w.device
            self.layers[name] = {
                "wq": wq.permute(0, 2, 3, 1).contiguous(),  # (Cout, KH, KW, Cin)
                "dequant": s_w * torch.tensor(s_x, dtype=torch.float32, device=dev),
                "bias": b,
                "inv": torch.tensor(1.0 / s_x, dtype=torch.float32, device=dev),
            }
        self.fc_w = sd["fc.weight"].float().t().contiguous()
        self.fc_b = sd["fc.bias"].float()
        inv0 = self.layers["conv1"]["inv"]
        byte = torch.arange(256, device=inv0.device, dtype=torch.float32)
        self.lut = torch.clamp(torch.round(byte * (inv0 / 255.0)), -q, q)

    def _quant(self, xf, name):
        q = float(self.qmax)
        return torch.clamp(torch.round(xf.float() * self.layers[name]["inv"]), -q, q)

    def _acc(self, name, x8, stride):
        return int_conv(x8, self.layers[name]["wq"], stride).to(torch.float32)

    def _affine(self, name, x8, stride):
        L = self.layers[name]
        return self._acc(name, x8, stride) * L["dequant"] + L["bias"]

    def trunk(self, u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 images → the last block's float32 output."""
        q = float(self.qmax)
        bl = blocks(self.stage_sizes)
        x8 = s2d4(self.lut[u8.long()])
        o = torch.relu(self._affine("conv1", x8, 1))
        x_bf = o.to(torch.bfloat16)
        x8 = self._quant(x_bf, f"{bl[0][0]}.conv1")
        for bi, (name, stride) in enumerate(bl):
            L1 = self.layers[f"{name}.conv1"]
            nxt = self.layers[f"{name}.conv2"]["inv"]
            h = self._acc(f"{name}.conv1", x8, stride) * (L1["dequant"] * nxt) + L1["bias"] * nxt
            h8 = torch.clamp(torch.round(torch.relu(h)), -q, q)
            if f"{name}.downsample_conv" in self.layers:
                r = self._affine(f"{name}.downsample_conv", x8, stride)
            else:
                r = x_bf.float()
            o = torch.relu(self._affine(f"{name}.conv2", h8, 1) + r)
            if bi + 1 == len(bl):
                return o
            x_bf = o.to(torch.bfloat16)
            x8 = self._quant(x_bf, f"{bl[bi + 1][0]}.conv1")
        raise AssertionError("unreachable")

    def logits(self, u8: torch.Tensor) -> torch.Tensor:
        """(B, classes) float32 logits of (B, 224, 224, 3) uint8 patches."""
        return self.trunk(u8).mean(dim=(1, 2)) @ self.fc_w + self.fc_b

    def features(self, u8: torch.Tensor) -> torch.Tensor:
        """The stride-32 feature map of uint8 tiles, as the fcn mode takes it
        to the head: rounded to bf16, then float32."""
        return self.trunk(u8).to(torch.bfloat16).float()
