"""The UNI2-h family (a ViT with class and register tokens, LayerScale and a
gated MLP): the program's model from the configuration, its seeded weights,
the reference's forwards, and the work a request needs, counted from the
configuration's shapes here (``core/flops.py``'s ViT counts assume a GELU
MLP and no extra tokens)."""

from __future__ import annotations

import torch

from ..core.flops import HBM_BYTES_PER_S, PEAK_OPS, equivalent_patches
from ..core.weights import draw, float_shapes, whitened_head
from ..reference import uni2h as ref
from ..reference.common import precise
from . import vit as vit_family


def program_model(cfg: dict):
    from deephisto_tpu_torch.models import RegViT

    return RegViT(cfg["num_classes"], patch=cfg["patch"], dim=cfg["dim"], depth=cfg["depth"],
                  heads=cfg["heads"], mlp_hidden=cfg["mlp_hidden"],
                  reg_tokens=cfg["reg_tokens"], dtype=torch.bfloat16,
                  img_size=cfg["patch_size"])


def _rule(name: str, shape) -> tuple:
    """The ViT family's draw, and for the tokens and LayerScale their own."""
    if name in ("cls_token", "reg_token"):
        return ("normal", 0.0, 0.02)
    if name.rsplit(".", 1)[-1] in ("ls1", "ls2"):  # every block contributes (a trained γ is
        return ("normal", 0.5, 0.1)                # far from its 1e-5 init)
    return vit_family._rule(name, shape)


def make_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = float_shapes(program_model(cfg))
    return draw(shapes, {k: _rule(k, s) for k, s in shapes.items()}, seed, device)


def pooled_features(cfg: dict, sd: dict, u8: torch.Tensor) -> torch.Tensor:
    with precise():
        return ref.forward(sd, cfg, u8.float() / 255.0, pooled=True)


# Leading principal directions of the class-token features the probe leaves
# out. Over the cohort's slides (noise over flat colour blocks) they carry
# the blocks' colour, with margins so wide that not even the float8 control
# changes a class; a tissue probe reads finer structure. Read past them, the
# bf16 program and the float8 control separate (PERF.md, §6, UNI2-h).
HEAD_SKIP = 10


def fit_head(cfg: dict, sd: dict, u8: torch.Tensor, seed: int) -> None:
    """The head fitted to the float model's class-token features of
    ``u8``'s patches: :func:`~port_bench.core.weights.whitened_head` of the
    features with their ``HEAD_SKIP`` leading principal directions taken
    out, so its classes are their next ``num_classes`` directions,
    whitened and mixed by a seeded rotation."""
    f = pooled_features(cfg, sd, u8).double().cpu()
    _, _, vh = torch.linalg.svd(f - f.mean(0), full_matrices=False)
    lead = vh[:HEAD_SKIP]
    w, b = whitened_head(f - (f - f.mean(0)) @ lead.t() @ lead, cfg["num_classes"], seed)
    sd["head.weight"], sd["head.bias"] = w.to(sd["head.weight"].device), b.to(sd["head.bias"].device)


class Reference:
    """The float32 reference of the bf16 configuration, and its control: the
    same in float8 e4m3 wherever the program holds bf16
    (:func:`~port_bench.reference.uni2h.forward`)."""

    def __init__(self, cfg: dict, sd: dict, device):
        self.cfg, self.sd = cfg, sd

    def slide_logits(self, control: bool = False):
        def logits(u8):
            with precise():
                return ref.forward(self.sd, self.cfg, u8.float() / 255.0, control=control)
        return logits


def tokens(cfg: dict) -> int:
    """Tokens a patch carries: the class token, the registers, the patches."""
    return 1 + cfg["reg_tokens"] + (cfg["patch_size"] // cfg["patch"]) ** 2


def patch_ops(cfg: dict) -> float:
    """Operations of one forward (2 a multiply-add): the patch conv, then per
    block qkv, Q·Kᵀ and P·V, proj, fc1 (2·mlp_hidden wide) and fc2. At the
    published sizes (256 patches, N = 265, dim 1536, hidden 4096, 24
    blocks): embed 256·1536·588 = 231,211,008 MACs; a block 265·1536·4608 +
    2·265²·1536 + 265·1536² + 265·1536·8192 + 265·4096·1536 = 1,875,640,320
    + 215,731,200 + 625,213,440 + 3,334,471,680 + 1,667,235,840 =
    7,718,292,480 MACs; in all 2 · (231,211,008 + 24 · 7,718,292,480) =
    370,940,461,056 operations. The head (dim × classes) is left out."""
    p, dim, hidden = cfg["patch"], cfg["dim"], cfg["mlp_hidden"]
    n_p, n = (cfg["patch_size"] // p) ** 2, tokens(cfg)
    embed = n_p * dim * 3 * p * p
    block = n * dim * 3 * dim + 2 * n * n * dim + n * dim * dim + n * dim * 2 * hidden \
        + n * hidden * dim
    return 2.0 * (embed + cfg["depth"] * block)


def k3_bound_s(cfg: dict, n_images: int) -> float:
    """The least time of the attention calls of ``n_images`` forwards at N
    tokens: 4·B·N²·dim operations at the bf16 peak, or q, k, v read and the
    output written once in bf16 (4·B·N·dim·2 bytes), the larger, summed over
    the blocks. At N = 265 the bytes bound it."""
    n, dim = tokens(cfg), cfg["dim"]
    ops = 4.0 * n_images * n * n * dim
    nbytes = 4.0 * n_images * n * dim * 2
    return cfg["depth"] * max(ops / PEAK_OPS["bfloat16"], nbytes / HBM_BYTES_PER_S)


def glu_bound_s(cfg: dict, n_images: int) -> float:
    """The least time of K7's calls for ``n_images`` forwards: per block its
    (N·images, 2·hidden) bf16 input read and its (N·images, hidden) output
    written once, 3·N·hidden·2 bytes an image, at HBM bandwidth: 0.497 ms a
    block for 256 patches at the published sizes."""
    return cfg["depth"] * 3.0 * n_images * tokens(cfg) * cfg["mlp_hidden"] * 2 / HBM_BYTES_PER_S


def request_counts(cfg: dict, mode: str, h: int, w: int) -> dict:
    """``work_ops``: the exact mode's patches × a forward; ``k3_bound_s`` and
    ``glu_bound_s``: the bound times of their attention and gate calls."""
    if mode != "dense":
        raise ValueError(f"UNI2-h serves the exact dense mode here, not {mode!r}")
    n = equivalent_patches(h, w)
    return {"work_ops": n * patch_ops(cfg), "k3_bound_s": k3_bound_s(cfg, n),
            "glu_bound_s": glu_bound_s(cfg, n)}
