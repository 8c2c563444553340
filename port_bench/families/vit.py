"""The ViT family with the patchify stem: the program's model from the
configuration, its seeded weights, the reference's forwards and the work a
request needs."""

from __future__ import annotations

import math

import torch

from ..core import flops
from ..core.weights import draw, float_shapes, whitened_head
from ..reference import vit as ref
from ..reference.common import precise


def program_model(cfg: dict):
    from deephisto_tpu_torch.models.patch_cls_simple import get_model

    return get_model(cfg["num_classes"], depth=cfg["depth"], dtype=torch.bfloat16,
                     stem=cfg["stem"], arch="vit", patch=cfg["patch"],
                     input_size=cfg["patch_size"])


def _rule(name: str, shape) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    if name == "pos_embed":
        return ("normal", 0.0, 0.02)
    if name.startswith("head."):
        return ("normal", 0.0, 1.0 / math.sqrt(shape[1])) if leaf == "weight" else (
            "const", 0.0, None)
    if ".ln" in name or name.startswith("ln."):
        return ("normal", 1.0, 0.1) if leaf == "weight" else ("normal", 0.0, 0.02)
    if leaf == "weight":  # the stem conv and every Dense: LeCun normal
        return ("normal", 0.0, 1.0 / math.sqrt(math.prod(shape[1:])))
    return ("normal", 0.0, 0.02)


def make_weights(cfg: dict, seed: int, device) -> dict:
    shapes = float_shapes(program_model(cfg))
    return draw(shapes, {k: _rule(k, s) for k, s in shapes.items()}, seed, device)


def pooled_features(cfg: dict, sd: dict, u8: torch.Tensor) -> torch.Tensor:
    with precise():
        return ref.forward(sd, cfg, u8.float() / 255.0, pooled=True)


def fit_head(cfg: dict, sd: dict, u8: torch.Tensor, seed: int) -> None:
    """The head fitted to the float model's pooled features of ``u8``'s
    patches (:func:`~port_bench.core.weights.whitened_head`)."""
    w, b = whitened_head(pooled_features(cfg, sd, u8), cfg["num_classes"], seed)
    sd["head.weight"], sd["head.bias"] = w.to(sd["head.weight"].device), b.to(sd["head.bias"].device)


class Reference:
    """The float32 reference of the bf16 configuration, and its control:
    every product's operands rounded to float8 e4m3."""

    def __init__(self, cfg: dict, sd: dict, device):
        self.cfg, self.sd = cfg, sd

    def slide_logits(self, control: bool = False):
        mm = ref.fp8_mm if control else ref.f32_mm

        def logits(u8):
            with precise():
                return ref.forward(self.sd, self.cfg, u8.float() / 255.0, mm=mm)
        return logits


def request_counts(cfg: dict, mode: str, h: int, w: int) -> dict:
    """``work_ops``: the exact mode's patches × a 224² forward;
    ``k3_bound_s``: the bound time of their attention calls."""
    if mode != "dense":
        raise ValueError(f"the ViT serves the exact dense mode here, not {mode!r}")
    n = flops.equivalent_patches(h, w)
    return {"work_ops": n * flops.vit_patch_ops(cfg),
            "k3_bound_s": flops.attention_bound_s(cfg, n)}
