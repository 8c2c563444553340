"""The port's geometry functions that no sampler test reaches, against the
JAX package's: ``clip_area_box`` (the same numpy code: equal),
``clip_area_regions`` and ``shoelace_area_device`` (float32: within 5e-2
px², each area the difference of two sums of 5V products up to 64², reduced
in other orders; readings up to 3.1e-2, as ``clip_area_batch`` is held in
``test_torch_sampler.py``; whole polygons' areas within 2e-5 of their
size), and ``multi_class_mask``, pixel for
pixel against the JAX function's PIL fill on the conftest dataset's
annotations at scale 1 and 1/4; and ``polygon_mask``'s ``scale``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.geometry import clip_area_box as jax_clip_area_box
from deephisto_tpu.geometry import clip_area_regions as jax_clip_area_regions
from deephisto_tpu.geometry import multi_class_mask as jax_multi_class_mask
from deephisto_tpu.geometry import shoelace_area_device as jax_shoelace_area_device
from deephisto_tpu.slide import star_polygon
from deephisto_tpu_torch.geometry import (
    clip_area_box,
    clip_area_regions,
    multi_class_mask,
    pad_polygons,
    polygon_mask,
    shoelace_area_device,
)
from deephisto_tpu_torch.slide import open_slide
from deephisto_tpu_torch.utils import get_img_ano_paths


def _polys(rng, n=6):
    return [star_polygon(rng, (rng.uniform(60, 200), rng.uniform(60, 200)), 50,
                         int(rng.integers(5, 24))) for _ in range(n)]


def _boxes(rng, n):
    xy = rng.uniform(0, 260, (n, 2))
    s = rng.uniform(8, 64, (n, 1))
    return np.concatenate([xy, xy + s], axis=1)


def test_clip_area_box_equals_the_jax_function():
    rng = np.random.default_rng(0)
    for poly in _polys(rng):
        for b in _boxes(rng, 20):
            assert clip_area_box(poly, *b) == jax_clip_area_box(poly, *b)


def test_clip_area_regions_and_shoelace_area_device_match_jax():
    rng = np.random.default_rng(1)
    verts = pad_polygons(_polys(rng), 32)  # (R, V, 2) float32
    idx = rng.integers(0, len(verts), 256).astype(np.int32)
    boxes = _boxes(rng, 256).astype(np.float32)
    got = clip_area_regions(torch.from_numpy(verts), torch.from_numpy(idx), torch.from_numpy(boxes))
    want = np.asarray(jax_clip_area_regions(jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(boxes)))
    assert got.dtype == torch.float32 and got.shape == (256,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)
    assert (want > 0).sum() > 50  # the boxes do cut the polygons
    areas = shoelace_area_device(torch.from_numpy(verts))
    # whole polygons: areas up to 8e3 px² from products of coordinates up to
    # 300, so a relative bound (readings up to 8.2e-6)
    np.testing.assert_allclose(areas.numpy(), np.asarray(jax_shoelace_area_device(jnp.asarray(verts))),
                               rtol=2e-5)


def _annotations(dataset):
    """[(path, (h, w), [(class id, vertices)])] of every slide of the
    dataset, class ids by sorted class name."""
    pairs = get_img_ano_paths(dataset, "train") + get_img_ano_paths(dataset, "test")
    raw = [(p, json.loads(a.read_text())) for p, a in pairs]
    classes = sorted({r["class"] for _, annos in raw for r in annos})
    out = []
    for p, annos in raw:
        with open_slide(p) as s:
            hw = s.layer_size(1)
        out.append((p, hw, [(classes.index(r["class"]), np.asarray(r["vertices"], np.float64))
                            for r in annos]))
    return out


# Pixels where the port's fill differs from PIL 12's on the conftest
# dataset: each at a sharp polygon corner (both edges leaving the vertex on
# the same side), where PIL joins the corner by a rule the port reproduces
# from PIL's behaviour, not from its source (ROADMAP §C).
KNOWN_CORNER_PIXELS = {1.0: 2, 0.25: 1}


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_multi_class_mask_is_pil_exact_on_the_dataset(synthetic_dataset, scale):
    n_pixels = n_painted = n_diff = 0
    for _, (h, w), annos in _annotations(synthetic_dataset):
        h, w = int(h * scale), int(w * scale)
        got = multi_class_mask(annos, h, w, scale=scale)
        want = jax_multi_class_mask(annos, h, w, scale=scale)
        assert got.dtype == np.int32 and got.shape == (h, w)
        corners = np.concatenate([np.asarray(v) * scale for _, v in annos]).astype(int)
        for y, x in np.argwhere(got != want):
            # a differing pixel lies beside a vertex, on its row
            assert (np.abs(corners[:, 0] - x) <= 3) @ (corners[:, 1] == y) > 0, (x, y)
            n_diff += 1
        n_pixels += got.size
        n_painted += int((got >= 0).sum())
    assert 0 < n_painted < n_pixels
    assert n_diff <= KNOWN_CORNER_PIXELS[scale], n_diff


def test_multi_class_mask_paints_later_polygons_over_earlier_ones():
    square = np.array([[2, 2], [12, 2], [12, 12], [2, 12]], np.float64)
    m = multi_class_mask([(3, square), (5, square + 4)], 20, 20, background=9)
    assert m[3, 3] == 3 and m[10, 10] == 5 and m[0, 0] == 9 and m[15, 15] == 5
    np.testing.assert_array_equal(m, jax_multi_class_mask([(3, square), (5, square + 4)], 20, 20,
                                                          background=9))


def test_polygon_mask_scale_is_a_vertex_scale():
    poly = star_polygon(np.random.default_rng(3), (80, 90), 60, 12)
    np.testing.assert_array_equal(polygon_mask(poly, 60, 70, scale=0.5),
                                  polygon_mask(poly * 0.5, 60, 70))
