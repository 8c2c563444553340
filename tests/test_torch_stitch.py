"""Stitch port vs the JAX package: ``scatter_add_map`` and
``scatter_add_map_exact`` on the same seeded coords and values, for d | ps
(fixed footprint) and d ∤ ps (per-patch spans), with coords whose footprints
run off the map. atol=1e-5: the sums run in index order on both sides, so
only XLA's own scatter lowering can reorder them. K2 itself runs only on a
card (test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.ops import stitch as jstitch
from deephisto_tpu_torch import _build
from deephisto_tpu_torch.ops import (
    coverage_footprint,
    map_footprint,
    scatter_add_map,
    scatter_add_map_exact,
    scatter_add_map_ref,
)

ATOL = 1e-5


def _raw_coords(h, w, ps, n=40, seed=0):
    """Layer coords: a dense grid's corners plus random ones, some running
    past the bottom/right edge of the map."""
    rng = np.random.default_rng(seed)
    grid = [(y, x) for y in range(0, h - ps + 1, ps // 2) for x in range(0, w - ps + 1, ps // 2)]
    rand = rng.integers(0, [h + ps, w + ps], size=(n, 2))
    return np.concatenate([np.asarray(grid), rand]).astype(np.int32)


@pytest.mark.parametrize("ps,d", [(224, 16), (200, 16), (64, 16), (60, 8)])
def test_scatter_add_map_exact_matches_jax(ps, d):
    h, w, c = 720, 1000, 5
    coords = _raw_coords(h, w, ps)
    vals = np.random.default_rng(1).standard_normal((len(coords), c)).astype(np.float32)
    want = np.asarray(
        jstitch.scatter_add_map_exact(
            jnp.zeros((h // d, w // d, c)), jnp.asarray(coords), jnp.asarray(vals), ps, d
        )
    )
    acc = torch.zeros((h // d, w // d, c))
    got = scatter_add_map_exact(acc, torch.from_numpy(coords), torch.from_numpy(vals), ps, d)
    assert got is acc  # added in place
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_scatter_add_map_with_spans_and_1d_values_matches_jax():
    rng = np.random.default_rng(2)
    dh, dw, f, n = 30, 40, 6, 50
    coords = rng.integers(0, [dh + 3, dw + 3], size=(n, 2)).astype(np.int32)
    spans = rng.integers(0, f + 3, size=(n, 2)).astype(np.int32)  # some past f
    vals = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(
        jstitch.scatter_add_map(
            jnp.zeros((dh, dw, 1)), jnp.asarray(coords), jnp.asarray(vals), f,
            spans=jnp.asarray(spans),
        )
    )
    got = scatter_add_map(
        torch.zeros((dh, dw, 1)), torch.from_numpy(coords), torch.from_numpy(vals), f,
        spans=torch.from_numpy(spans),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_negative_cells_are_dropped():
    """Negative map coords as JAX's ``.at[].add(mode="drop")`` takes them:
    indices in [-dh, 0) wrap to the far edge, those below -dh are dropped,
    and a footprint that straddles row or column 0 lands in up to four
    rectangles; fixed footprints and per-patch spans, f > the map's
    height included (a cell hit twice by one patch)."""
    rng = np.random.default_rng(4)
    n, c = 60, 3
    for (dh, dw), f in (((12, 17), 5), ((4, 9), 6)):
        coords = rng.integers([-dh - f - 2, -dw - f - 2], [dh + 2, dw + 2], size=(n, 2))
        coords[:4] = [(-1, -1), (-dh, 0), (-dh - 1, 3), (-2, dw - 2)]
        coords = coords.astype(np.int32)
        vals = rng.standard_normal((n, c)).astype(np.float32)
        spans = rng.integers(0, f + 2, size=(n, 2)).astype(np.int32)
        for sp in (None, spans):
            want = np.asarray(jstitch.scatter_add_map(
                jnp.zeros((dh, dw, c)), jnp.asarray(coords), jnp.asarray(vals), f,
                spans=None if sp is None else jnp.asarray(sp)))
            got = scatter_add_map(
                torch.zeros((dh, dw, c)), torch.from_numpy(coords), torch.from_numpy(vals), f,
                spans=None if sp is None else torch.from_numpy(sp))
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ps,d", [(224, 16), (200, 16), (7, 16), (33, 4)])
def test_footprints_match_jax(ps, d):
    assert map_footprint(ps, d) == jstitch.map_footprint(ps, d)
    assert coverage_footprint(ps, d) == jstitch.coverage_footprint(ps, d)


def test_scatter_add_map_checks_its_inputs():
    acc = torch.zeros((8, 8, 2))
    c = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        scatter_add_map(acc, c.long(), torch.ones(3, 2), 2)
    with pytest.raises(ValueError, match="channels"):
        scatter_add_map(acc, c, torch.ones(3, 3), 2)
    with pytest.raises(ValueError, match="float32"):
        scatter_add_map(acc.double(), c, torch.ones(3, 2), 2)
    with pytest.raises(ValueError, match="spans"):
        scatter_add_map(acc, c, torch.ones(3, 2), 2, spans=torch.zeros((2, 2), dtype=torch.int32))
    _build.reset_launches()
    scatter_add_map(acc, c, torch.ones(3, 2), 2)  # CPU map: the plain loop
    assert _build.launches.get("scatter_add_map", 0) == 0
