"""The port's sampling primitives (``ops/sampling.py``, B7 as torch ops)
against the JAX package's.

On the same numpy-made Gumbel noise, ``gumbel_topk`` and
``coverage_cell_topk`` must pick the same cells in the same order as
``jax.lax.top_k`` (exact: ties, as among saturated coverage cells, go to the
lower index). The port's own draws are held to distributions: inclusion
frequencies of sequential weighted sampling without replacement, the
categorical's frequencies, uniform integers; each within 4 standard errors
of the exact value over the trials."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.ops import sampling as jax_sampling
from deephisto_tpu_torch.ops import sampling


def _jax_coverage_cells(accum, dense_level, batch_size, noise):
    """deephisto_tpu/ops/sampling.py:coverage_cell_topk with its Gumbel noise
    given (the function draws it from a key)."""
    dw = accum.shape[1]
    p = jnp.where(accum >= dense_level, 0.0, 1.0)
    logp = jnp.where(p > 0, 0.0, -1e9).reshape(-1)
    _, cells = jax.lax.top_k(logp + noise, batch_size)
    return np.asarray(cells // dw), np.asarray(cells % dw)


@pytest.mark.parametrize("seed", range(4))
def test_gumbel_topk_picks_jax_cells(seed):
    """The same log weights and noise pick the same cells. ``log_weights``
    itself agrees to 1 ulp (XLA's log and torch's round differently)."""
    rng = np.random.default_rng(seed)
    n, k = 500, 37
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[rng.integers(0, n, 100)] = 0  # zero weights: -1e30 keys
    noise = rng.gumbel(size=n).astype(np.float32)
    logw = np.asarray(jax_sampling.log_weights(jnp.asarray(w)))
    want = np.asarray(jax.lax.top_k(jnp.asarray(logw) + noise, k)[1])
    got = sampling.gumbel_topk(torch.from_numpy(noise), torch.from_numpy(logw), k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(sampling.log_weights(torch.from_numpy(w)).numpy(), logw,
                               rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("saturated", [0.0, 0.5, 0.97, 1.0])
def test_coverage_cell_topk_picks_jax_cells(saturated):
    rng = np.random.default_rng(int(saturated * 100))
    dh, dw, bs = 24, 30, 64
    accum = np.where(rng.uniform(size=(dh, dw)) < saturated, 2.0, rng.integers(0, 2, (dh, dw)))
    accum = accum.astype(np.float32)
    noise = rng.gumbel(size=dh * dw).astype(np.float32)
    want = _jax_coverage_cells(jnp.asarray(accum), 2, bs, jnp.asarray(noise))
    for a in (accum, accum[..., None]):  # the port keeps a (dh, dw, 1) accumulator
        got = sampling.coverage_cell_topk(torch.from_numpy(noise), torch.from_numpy(a), 2, bs)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    cells = set(zip(*(g.tolist() for g in got)))
    assert len(cells) == bs  # without replacement
    free = int((accum < 2).sum())
    assert sum(accum[y, x] < 2 for y, x in cells) == min(bs, free)  # unsaturated first


def test_top_k_orders_ties_as_lax():
    x = np.array([1, 3, 3, -0.0, 0.0, 3, -1e9, -1e9, 2], np.float32)
    for k in range(1, len(x) + 1):
        np.testing.assert_array_equal(sampling.top_k(torch.from_numpy(x), k).numpy(),
                                      np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))
    with pytest.raises(ValueError):
        sampling.top_k(torch.from_numpy(x), 0)


def _inclusion_probabilities(w, k):
    """Exact P(i drawn) of sequential weighted sampling without replacement
    (np.random.choice(n, k, replace=False, p=w / w.sum()))."""
    n = len(w)
    p = np.zeros(n)
    for seq in itertools.permutations(range(n), k):
        prob, left = 1.0, w.sum()
        for i in seq:
            prob *= w[i] / left
            left -= w[i]
        for i in seq:
            p[i] += prob
    return p


def test_gumbel_topk_inclusion_frequencies():
    w = np.array([5.0, 3.0, 1.0, 0.5, 0.5, 0.0])
    k, trials = 2, 4000
    gen = torch.Generator().manual_seed(0)
    logw = sampling.log_weights(torch.tensor(w, dtype=torch.float32))
    counts = np.zeros(len(w))
    for _ in range(trials):
        counts[sampling.gumbel_topk(gen, logw, k).numpy()] += 1
    p = _inclusion_probabilities(w, k)
    se = np.sqrt(p * (1 - p) / trials)
    assert counts[-1] == 0  # a zero weight is never drawn
    np.testing.assert_array_less(np.abs(counts / trials - p), 4 * se + 1e-9)


def test_categorical_and_uniform_int_frequencies():
    gen = torch.Generator().manual_seed(1)
    w = torch.tensor([[1.0, 2.0, 0.0, 7.0]]).repeat(20000, 1)
    draws = sampling.categorical(gen, sampling.log_weights(w)).numpy()
    p = np.array([0.1, 0.2, 0.0, 0.7])
    freq = np.bincount(draws, minlength=4) / len(draws)
    np.testing.assert_array_less(np.abs(freq - p), 4 * np.sqrt(p * (1 - p) / len(draws)) + 1e-9)
    u = sampling.uniform_int(gen, torch.tensor([0, 5, 3]), torch.tensor([4, 6, 3]), (5000, 3)).numpy()
    assert set(np.unique(u[:, 0])) == {0, 1, 2, 3}
    assert (u[:, 1] == 5).all() and (u[:, 2] == 3).all()  # hi <= lo + 1 → lo
    freq = np.bincount(u[:, 0], minlength=4) / len(u)
    np.testing.assert_array_less(np.abs(freq - 0.25), 4 * np.sqrt(0.25 * 0.75 / len(u)))


def test_gumbel_noise_is_standard_gumbel():
    g = sampling.gumbel(torch.Generator().manual_seed(2), (50000,)).numpy()
    assert g.dtype == np.float32 and np.isfinite(g).all()
    assert abs(g.mean() - np.euler_gamma) < 4 * (np.pi / np.sqrt(6)) / np.sqrt(len(g))
    with pytest.raises(ValueError):
        sampling.gumbel_topk(torch.zeros(3), torch.zeros(4), 2)
