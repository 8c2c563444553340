"""Seeds and seeded weights. A configuration's weights are drawn on the
device from ``--seed`` in two large calls (one normal, one uniform draw),
then cut into the tensors of the model's state dict by each family's
rule; the head is then fitted to the seed's slides (:func:`whitened_head`).
The program's model and the reference both take that dict."""

from __future__ import annotations

import torch

from .seeds import derive


def draw(shapes: dict, rules: dict, seed: int, device) -> dict:
    """``shapes``: name → shape; ``rules``: name → (kind, a, b) with kind
    ``normal`` (mean a, std b), ``uniform`` (on [a, b)) or ``const`` (a).
    Returns name → float32 tensor on ``device``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    sizes = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    n_norm = sum(sizes[k] for k in shapes if rules[k][0] == "normal")
    n_unif = sum(sizes[k] for k in shapes if rules[k][0] == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    uniform = torch.rand(n_unif, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for k, shape in shapes.items():
        kind, a, b = rules[k]
        n = sizes[k]
        if kind == "normal":
            t = normal[i:i + n] * b + a
            i += n
        elif kind == "uniform":
            t = uniform[j:j + n] * (b - a) + a
            j += n
        else:
            t = torch.full((n,), float(a), device=device)
        out[k] = t.reshape(shape).contiguous()
    return out


def float_shapes(model: torch.nn.Module) -> dict:
    """name → shape of every floating-point tensor of the state dict."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items() if v.is_floating_point()}


def whitened_head(features: torch.Tensor, k: int, seed: int):
    """(weight (k, C), bias (k,)) of a linear head over (n, C) pooled
    features: their k principal directions, each scaled to unit variance
    over the n samples, mixed by a seeded rotation, the bias centring them.
    A random trunk's features share a large common part and vary along a
    few directions; a random head over them lets one class win nearly every
    patch, where this one gives every class a part of every seed's slides."""
    f = features.double().cpu()
    mu = f.mean(0)
    _, sv, vh = torch.linalg.svd(f - mu, full_matrices=False)
    comps = vh[:k] * ((f.shape[0] - 1) ** 0.5 / sv[:k].clamp(min=1e-12))[:, None]
    gen = torch.Generator().manual_seed(derive(seed, "head"))
    rot, _ = torch.linalg.qr(torch.randn(k, k, generator=gen, dtype=torch.float64))
    w = rot @ comps
    return w.float(), (-(w @ mu)).float()
