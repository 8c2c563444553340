"""ResNet family in PyTorch, a port of ``deephisto_tpu/models/resnet.py``.

Module and parameter names follow the flax model (``conv1``, ``bn1``,
``layer{i}_{j}.conv{k}``, ``downsample_conv``, ``fc``), so
:func:`..convert.flax_resnet_to_torch` maps one onto the other by name.

The public call takes NHWC input and returns NHWC feature maps, as the JAX
model does. Inside, ``permute(0, 3, 1, 2)`` gives an NCHW view of
channels_last memory, so the NHWC patches K1 writes reach cuDNN without a
copy; the weights are held channels_last too.

Numerics follow flax: convs pad as XLA's ``SAME`` (see :class:`SameConv2d`),
BN eps is 1e-5 and runs in float32 on the model-dtype activations, the GAP
mean stays in the model dtype and ``fc`` runs in float32. Every parameter is
held in float32, as flax holds its params: the convs cast their kernels to
the activations' dtype at each call, as ``nn.Conv(dtype=...)`` does, so an
optimizer updates float32 weights. In train mode BatchNorm is flax's (see
:class:`BatchNorm`), not torch's.
"""

from __future__ import annotations

import re
from functools import partial
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA ``SAME`` padding of one axis: ``out = ceil(n/s)``, ``pad_total =
    max((out-1)·s + k - n, 0)``, ``lo = pad_total // 2``. A stride-2 3×3
    conv on an even extent pads (0, 1), not the (1, 1) of torch's
    ``padding=1``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def cast_param(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``module``'s float32 parameter ``name`` in the compute ``dtype``, as
    flax casts its params at each call. Under ``torch.inference_mode`` the
    cast is kept on the module and made again only when the parameter
    changes (its storage or version counter), so a predict does not pay a
    cast of every weight for every batch; otherwise it is cast at each call,
    so autograd sees the cast."""
    p = getattr(module, name)
    if p.dtype == dtype or not torch.is_inference_mode_enabled():
        return p.to(dtype)
    key = (dtype, p.data_ptr(), p._version)
    cache = module.__dict__.setdefault("_casts", {})
    if name not in cache or cache[name][0] != key:
        cache[name] = (key, p.to(dtype))
    return cache[name][1]


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters cast to the input's dtype at
    each call (flax ``nn.Conv(dtype=...)`` on float32 params)."""

    def forward(self, x):
        bias = None if self.bias is None else cast_param(self, "bias", x.dtype)
        return self._conv_forward(x, cast_param(self, "weight", x.dtype), bias)


class SameConv2d(CastConv2d):
    """Bias-free conv with XLA ``SAME`` padding (flax ``nn.Conv``'s default),
    computed per call from the input extent. Symmetric padding goes to the
    conv itself; asymmetric padding is an explicit ``F.pad`` first."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        w = cast_param(self, "weight", x.dtype)
        (ty, by), (lx, rx) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
        if ty == by and lx == rx:
            return F.conv2d(x, w, None, self.stride, (ty, lx))
        return F.conv2d(F.pad(x, (lx, rx, ty, by)), w, None, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    an NCHW tensor, float32 parameters and statistics on model-dtype
    activations.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics (float32, the biased variance) and updates the
    running ones as flax does (flax/linen/normalization.py): mean and
    ``var = max(0, E[x²] - E[x]²)`` in float32, then ``ra = 0.9·ra + 0.1·stat``
    for both. torch's own BatchNorm feeds the running variance the unbiased
    batch variance instead."""

    MOMENTUM = 0.9  # flax's: the weight of the old running value

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=1.0 - self.MOMENTUM)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.float()
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean * (1.0 - m))
            self.running_var.mul_(m).add_(var * (1.0 - m))
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, filters, 3, strides)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.has_downsample = cin != filters or strides != 1
        if self.has_downsample:
            self.downsample_conv = SameConv2d(cin, filters, 1, strides)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = self.bn2(self.conv2(y))
        r = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(r + y, inplace=True)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = SameConv2d(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.conv3 = SameConv2d(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4)
        self.has_downsample = cin != filters * 4 or strides != 1
        if self.has_downsample:
            self.downsample_conv = SameConv2d(cin, filters * 4, 1, strides)
            self.downsample_bn = BatchNorm(filters * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        r = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(r + y, inplace=True)


class ResNet(nn.Module):
    """conv1 stem → 4 stages of blocks → GAP → fc, as the flax ``ResNet``.

    stem: "imagenet" (7×7/2 conv padded (3, 3), then 3×3/2 max-pool padded
    (1, 1)) or "s2d" (4×4 space-to-depth of the input, then a 2×2 SAME
    conv; the input extent must be a multiple of 4). Input is RGB, or
    ``in_channels`` channels (9 for three magnifications stacked; flax infers
    the stem's input channels from its first input)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        num_classes: int,
        num_filters: int = 64,
        dtype: torch.dtype = torch.bfloat16,
        stem: str = "imagenet",
        in_channels: int = 3,
    ):
        super().__init__()
        if stem not in ("imagenet", "s2d"):
            raise ValueError(f"stem must be 'imagenet' or 's2d', got {stem!r}")
        self.stage_sizes = tuple(stage_sizes)
        self.num_filters = num_filters
        self.dtype = dtype
        self.stem = stem
        self.in_channels = in_channels
        if stem == "s2d":
            self.conv1 = SameConv2d(16 * in_channels, num_filters, 2)
        else:
            self.conv1 = CastConv2d(in_channels, num_filters, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(num_filters)
        self.stages: list[list[str]] = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            self.stages.append([])
            for j in range(count):
                filters = num_filters * 2**i
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(cin, filters, 2 if i > 0 and j == 0 else 1))
                self.stages[i].append(name)
                cin = filters * block_cls.expansion
        self.fc = nn.Linear(cin, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)

    def forward(self, x, features: bool = False, up_to: str | None = None,
                pre_packed: bool = False):
        """x: (B, H, W, C). Returns (B, num_classes) float32 logits, or with
        ``features=True`` the pre-GAP feature map (B, H/32, W/32, C'), or with
        ``up_to`` in {"stem", "layer1".."layer4"} the NHWC tensor after that
        boundary. ``pre_packed=True`` (s2d stem only): ``x`` is already the
        4×4 space-to-depth form (B, H/4, W/4, 48), as the predicts gather it
        from a packed slide."""
        if pre_packed and self.stem != "s2d":
            raise ValueError("pre_packed input requires the s2d stem")
        x = x.to(self.dtype)
        if self.stem == "s2d" and not pre_packed:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(b, h // 4, w // 4, 16 * c)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC (channels_last) memory
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, padding=1)
        if up_to == "stem":
            return x.permute(0, 2, 3, 1)
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if up_to == f"layer{i + 1}":
                return x.permute(0, 2, 3, 1)
        if features:
            return x.permute(0, 2, 3, 1)
        x = x.mean(dim=(2, 3))
        return self.fc(x.float())


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck)

_DEPTHS = {18: ResNet18, 34: ResNet34, 50: ResNet50, 101: ResNet101}


def build_resnet(
    num_classes: int,
    depth: int = 18,
    dtype: torch.dtype = torch.bfloat16,
    stem: str = "imagenet",
    width: int = 1,
    in_channels: int = 3,
) -> ResNet:
    """ResNet by depth (18/34/50/101); ``width`` multiplies every stage's
    channel count; ``in_channels`` input channels."""
    try:
        ctor = _DEPTHS[depth]
    except KeyError:
        raise ValueError(
            f"unsupported ResNet depth {depth}; choose from {sorted(_DEPTHS)}"
        ) from None
    return ctor(num_classes=num_classes, dtype=dtype, stem=stem, num_filters=64 * width,
                in_channels=in_channels)


def _torchvision_file(depth: int, path=None) -> Path | None:
    """``path``, or the first ``resnet{depth}-*.pth`` under torch hub's
    ``checkpoints`` directory (where torchvision caches its downloads)."""
    if path is not None:
        return Path(path) if Path(path).is_file() else None
    found = sorted((Path(torch.hub.get_dir()) / "checkpoints").glob(f"resnet{depth}-*.pth"))
    return found[0] if found else None


_TV_BLOCK = re.compile(r"^layer(\d)\.(\d+)\.(.+)$")


@torch.no_grad()
def load_torchvision_weights(model: ResNet, depth: int = 18, path=None) -> ResNet | None:
    """Load torchvision's ImageNet ResNet weights into ``model``'s backbone
    from a local file (the port of ``deephisto_tpu/models/resnet.py:
    load_torchvision_weights``): ``path``, or the first
    ``resnet{depth}-*.pth`` under ``torch.hub.get_dir()/checkpoints``, read
    with ``torch.load(weights_only=True)``. torchvision's names map onto the
    port's (``layer{s}.{j}.conv1`` → ``layer{s}_{j}.conv1``,
    ``downsample.0``/``.1`` → ``downsample_conv``/``downsample_bn``); both
    hold OIHW kernels. The randomly initialized ``fc`` is kept, as the
    reference replaces it. Returns ``model``, or None when no file exists;
    nothing is downloaded."""
    f = _torchvision_file(depth, path)
    if f is None:
        return None
    sd = torch.load(f, map_location="cpu", weights_only=True)
    own = model.state_dict()
    mapped = {}
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        m = _TV_BLOCK.match(k)
        if m:
            stage, j, rest = m.groups()
            rest = rest.replace("downsample.0.", "downsample_conv.").replace(
                "downsample.1.", "downsample_bn.")
            k = f"layer{stage}_{j}.{rest}"
        if k not in own or own[k].shape != v.shape:
            raise ValueError(f"{f}: {k} {tuple(v.shape)} does not fit this ResNet-{depth}")
        mapped[k] = v
    for k, v in mapped.items():
        own[k].copy_(v)
    return model
