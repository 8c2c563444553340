"""The ResNet family with the s2d stem: the program's model from the
configuration, its seeded weights, the reference's forwards and the work a
request needs."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import flops
from ..core.weights import draw, float_shapes, whitened_head
from ..reference import resnet as ref
from ..reference.common import precise


def program_model(cfg: dict):
    from deephisto_tpu_torch.models.patch_cls_simple import get_model

    return get_model(cfg["num_classes"], depth=cfg["depth"], dtype=torch.bfloat16,
                     stem=cfg["stem"], arch="resnet", width=cfg["width"])


def _rule(name: str, shape) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    if "bn" in name.rsplit(".", 2)[-2]:
        return {"weight": ("uniform", 0.5, 1.5), "bias": ("normal", 0.0, 0.1),
                "running_mean": ("normal", 0.0, 0.1),
                "running_var": ("uniform", 0.5, 1.5)}[leaf]
    if leaf == "weight":  # convs and the head: LeCun normal
        return ("normal", 0.0, 1.0 / math.sqrt(math.prod(shape[1:])))
    return ("const", 0.0, None)  # the head's bias (fitted later)


def make_weights(cfg: dict, seed: int, device) -> dict:
    shapes = float_shapes(program_model(cfg))
    return draw(shapes, {k: _rule(k, s) for k, s in shapes.items()}, seed, device)


def stage_sizes(cfg: dict):
    return cfg["stage_sizes"]


def pooled_features(cfg: dict, sd: dict, u8: torch.Tensor) -> torch.Tensor:
    """The float model's pooled features of (B, 224, 224, 3) uint8 patches."""
    with precise():
        return ref.float_forward(sd, stage_sizes(cfg), u8.float() / 255.0, pooled=True)


def fit_head(cfg: dict, sd: dict, u8: torch.Tensor, seed: int) -> None:
    """The head fitted to the float model's pooled features of ``u8``'s
    patches (:func:`~port_bench.core.weights.whitened_head`)."""
    w, b = whitened_head(pooled_features(cfg, sd, u8), cfg["num_classes"], seed)
    sd["fc.weight"], sd["fc.bias"] = w.to(sd["fc.weight"].device), b.to(sd["fc.bias"].device)


def calib_batches(cfg: dict, device) -> list:
    """The engine's default calibration set (``ServingEngine``'s ``calib=None``):
    64 images of 224² drawn by ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.random((64, 224, 224, 3), dtype=np.float32)).to(device)]


class Reference:
    """The reference of the configuration's served precision (``qmax`` 127:
    the int8 model) and of its control (int4), for slides."""

    def __init__(self, cfg: dict, sd: dict, device):
        self.cfg, self.sd = cfg, sd
        with precise():
            self.q8 = ref.QuantRef(sd, stage_sizes(cfg), calib_batches(cfg, device), 127)
            self.q4 = ref.QuantRef(sd, stage_sizes(cfg), None, 7, absmax=self.q8.absmax)
        self.fc_w, self.fc_b = self.q8.fc_w, self.q8.fc_b

    def slide_logits(self, control: bool = False):
        q = self.q4 if control else self.q8
        return lambda u8: _precise_call(q.logits, u8)

    def slide_features(self, control: bool = False):
        q = self.q4 if control else self.q8
        return lambda u8: _precise_call(q.features, u8)


def _precise_call(fn, x):
    with precise():
        return fn(x)


def request_counts(cfg: dict, mode: str, h: int, w: int) -> dict:
    """The work one slide request needs, from the configuration's shapes:
    ``work_ops`` (the model's operations: the exact mode's patches × a 224²
    forward; the fcn mode's backbone once over h × w, no halo) and
    ``k6_bound_s`` (Σ of each int8 conv's bound time: per 256-patch batch in
    the exact mode, over the whole slide in fcn)."""
    prec = cfg["precision"]
    if mode == "fcn":
        convs = flops.resnet_convs(cfg, h, w)
        return {"work_ops": sum(flops.conv_ops(c) for c in convs),
                "k6_bound_s": sum(flops.conv_bound_s(c, 1, prec) for c in convs)}
    n = flops.equivalent_patches(h, w)
    convs = flops.resnet_convs(cfg, 224, 224)
    bs = cfg["dense_batch"]
    batches = [bs] * (n // bs) + ([n % bs] if n % bs else [])
    per = {b: sum(flops.conv_bound_s(c, b, prec) for c in convs) for b in set(batches)}
    return {"work_ops": n * flops.resnet_patch_ops(cfg),
            "k6_bound_s": sum(per[b] for b in batches)}
