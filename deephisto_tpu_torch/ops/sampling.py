"""Weighted sampling primitives on the device, a port of
``deephisto_tpu/ops/sampling.py`` (B7) as torch ops.

Categorical draws are log-weights plus Gumbel noise, then an argmax;
sampling without replacement is Gumbel-top-k, which is sequential weighted
sampling without replacement in distribution (reference full_samplers.py:
136-143). Each draw takes a ``torch.Generator`` where the JAX function takes
a key, or the Gumbel noise itself (a tensor of the logits' shape), so that a
test can give both packages the same noise.

:func:`top_k` orders as ``jax.lax.top_k`` does, by value and then by index
among equal values, so that the same noise picks the same cells in the same
order: saturated coverage cells share one key (-1e9 absorbs the noise in
float32).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def log_weights(w: torch.Tensor) -> torch.Tensor:
    """log of (unnormalized, possibly zero-padded) weights, -inf-safe."""
    return torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-38)), NEG_INF)


def gumbel(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise in float32, ``-log(-log(u))`` with u uniform in
    [tiny, 1) (as ``jax.random.gumbel``), from ``gen`` on ``device`` (the
    generator's device by default)."""
    u = torch.rand(shape, generator=gen, device=device or gen.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _noise(gen_or_noise, logw: torch.Tensor) -> torch.Tensor:
    if isinstance(gen_or_noise, torch.Generator):
        return gumbel(gen_or_noise, logw.shape, logw.device)
    noise = torch.as_tensor(gen_or_noise, dtype=torch.float32).to(logw.device)
    if noise.shape != logw.shape:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for logits {tuple(logw.shape)}")
    return noise


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 keys in the floats' order (the sign-magnitude bits
    of a negative float flipped)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-d float32 tensor, in the
    order of ``jax.lax.top_k``: by value, the lower index first among equal
    values. ``torch.topk`` runs on int64 keys that make every entry unique."""
    n = x.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k must be in 1..{n}, got {k}")
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    keys = _ordered_bits(x) * (1 << 32) + ((1 << 32) - 1 - idx)
    return torch.topk(keys, k).indices


def categorical(gen_or_noise, logw: torch.Tensor) -> torch.Tensor:
    """A weighted categorical draw over the last axis of ``logw`` (one per
    leading index): the argmax of logits plus Gumbel noise."""
    return torch.argmax(logw + _noise(gen_or_noise, logw), dim=-1)


def gumbel_topk(gen_or_noise, logw: torch.Tensor, k: int) -> torch.Tensor:
    """k indices of a 1-d ``logw`` sampled without replacement ∝ weights
    (Gumbel-top-k), as ``np.random.choice(n, size=k, replace=False, p=w)``
    draws them in distribution (reference full_samplers.py:136-143)."""
    return top_k(logw + _noise(gen_or_noise, logw), k)


def uniform_int(gen: torch.Generator, lo, hi, shape=(), device=None) -> torch.Tensor:
    """Integers uniform in [lo, hi) (tensors or ints, broadcast to
    ``shape``), with a degenerate range giving lo (hi <= lo + 1 → lo)."""
    device = device or gen.device
    lo = torch.as_tensor(lo, device=device).to(torch.int64)
    hi = torch.maximum(torch.as_tensor(hi, device=device).to(torch.int64), lo + 1)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.minimum(lo + (u * (hi - lo)).to(torch.int64), hi - 1)


def coverage_cell_topk(
    gen_or_noise, accum: torch.Tensor, dense_level: float, batch_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``batch_size`` distinct cells of a (dh, dw) or (dh, dw, 1)
    coverage accumulator, preferring unsaturated ones (accum < dense_level),
    uniformly without replacement; saturated cells have the finite key
    -1e9, so they are taken only when fewer than batch_size unsaturated
    cells remain (reference full_samplers.py:105-143). ``gen_or_noise`` is a
    generator or the (dh·dw,) float32 Gumbel noise. Returns (cell_y,
    cell_x), int64."""
    dw = accum.shape[1]
    logp = torch.where(accum.reshape(-1) >= dense_level, -1e9, 0.0).to(torch.float32)
    cells = gumbel_topk(gen_or_noise, logp, batch_size)
    return cells // dw, cells % dw
