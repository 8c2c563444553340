"""The port's annotation registry and visualizer against the JAX package's.

Palette and class registry: equal (the same colours for the same seed).
``AnnoVisualizer``: the port rasterizes PIL's polygon routines in numpy and
composites with PIL's integer formula; on the synthetic slide at least 99 %
of the pixels must equal the JAX package's (PIL) image and every differing
pixel must lie within 2 px of a polygon edge. Measured on these slides:
100 % equal at every size tested."""

import json

import numpy as np
import pytest

from deephisto_tpu import anno as jax_anno
from deephisto_tpu.slide import DEFAULT_COLORS, make_synthetic_slide
from deephisto_tpu_torch import anno as port_anno
from deephisto_tpu_torch.slide import ArraySlide


def _classes(d):
    return [(c.id, c.label, tuple(c.alternate_labels), c.description, tuple(c.color))
            for c in d.anno_classes]


@pytest.mark.parametrize("rng,known", [(3, ((10, 20, 30), (200, 100, 0))), (0, None),
                                       (7, None), (42, None)])
def test_palette_matches_jax(rng, known):
    got = port_anno.Palette(known, 6 if known else 9, rng=rng)
    assert got.colors == jax_anno.Palette(known, 6 if known else 9, rng=rng).colors
    assert port_anno.get_distinct_colors(5, pastel_factor=0.3, rng=rng) == \
        jax_anno.get_distinct_colors(5, pastel_factor=0.3, rng=rng)
    with pytest.raises(RuntimeError):
        port_anno.Palette(((300, 0, 0),))


def test_class_registry_matches_jax(tmp_path):
    labels = ["TUM", "AT", "BG", "LP", "MM"]
    assert _classes(port_anno.AnnoDescription.with_auto_colors(labels)) == \
        _classes(jax_anno.AnnoDescription.with_auto_colors(labels))
    got = port_anno.AnnoDescription.with_known_colors(DEFAULT_COLORS)
    assert _classes(got) == _classes(jax_anno.AnnoDescription.with_known_colors(DEFAULT_COLORS))
    assert got.color_by_label("TUM") == DEFAULT_COLORS["TUM"] and len(got) == len(DEFAULT_COLORS)
    c = port_anno.AnnoClass(0, "TUM", alternate_labels=("tumor",), color=(1, 2, 3))
    assert port_anno.AnnoDescription([c]).color_by_label("tumor") == (1, 2, 3)
    assert str(c) == str(jax_anno.AnnoClass(0, "TUM", alternate_labels=("tumor",), color=(1, 2, 3)))
    for i, cls in enumerate(["MM", "AT", "MM", "LP"]):
        (tmp_path / f"s{i}.json").write_text(json.dumps([{"class": cls, "vertices": []}]))
    (tmp_path / "notes.txt").write_text("not an annotation")
    assert _classes(port_anno.AnnoDescription.auto_from_files(tmp_path)) == \
        _classes(jax_anno.AnnoDescription.auto_from_files(tmp_path))
    assert _classes(port_anno.AnnoDescription.auto_from_files(tmp_path / "s1.json")) == \
        _classes(jax_anno.AnnoDescription.auto_from_files(tmp_path / "s1.json"))
    with pytest.raises(RuntimeError):
        port_anno.AnnoDescription.auto_from_files(tmp_path / "empty")


@pytest.fixture(scope="module")
def synthetic():
    slide, annos = make_synthetic_slide(seed=7, height=768, width=896, max_layer=4)
    level0 = slide.get_region_from_layer(1, (0, 0), (768, 896))
    polys = [(a["class"], np.array(a["vertices"])) for a in annos]
    return slide, ArraySlide(level0, max_layer=4), polys


def _within_2px_of_an_edge(shape, polys, factor):
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    near = np.zeros(shape, dtype=bool)
    for poly in polys:
        v = np.asarray(poly, dtype=np.float64) * factor
        for a, b in zip(v, np.roll(v, -1, axis=0)):
            d = b - a
            t = np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1]) / max(float(d @ d), 1e-12), 0, 1)
            near |= (xx - a[0] - t * d[0]) ** 2 + (yy - a[1] - t * d[1]) ** 2 <= 4.0
    return near


@pytest.mark.parametrize("max_side,accents", [(256, False), (512, True), (896, True)])
def test_visualizer_matches_jax(synthetic, max_side, accents):
    jslide, tslide, polys = synthetic
    desc = DEFAULT_COLORS
    jacc = [jax_anno.PatchVisAccent(layer=2, size=64, x=10, y=10, label="TUM"),
            jax_anno.PatchVisAccent.parse("r28_LP_7_x170_y140", layer=2, patch_s=48)]
    tacc = [port_anno.PatchVisAccent(layer=2, size=64, x=10, y=10, label="TUM"),
            port_anno.PatchVisAccent.parse("r28_LP_7_x170_y140", layer=2, patch_s=48)]
    want = np.asarray(jax_anno.AnnoVisualizer(
        jax_anno.AnnoDescription.with_known_colors(desc), jax_anno.AnnoVisualizerParams.no_legend(),
    ).visualize(jslide, polys, max_side=max_side, patch_accents=jacc if accents else None))
    got = port_anno.AnnoVisualizer(
        port_anno.AnnoDescription.with_known_colors(desc), port_anno.AnnoVisualizerParams.no_legend(),
    ).visualize(tslide, polys, max_side=max_side, patch_accents=tacc if accents else None)
    assert got.dtype == np.uint8 and got.shape == want.shape and max(got.shape[:2]) == max_side
    diff = (got != want).any(axis=-1)
    assert diff.mean() <= 0.01, diff.mean()
    factor = (got.shape[0] / 768 + got.shape[1] / 896) / 2
    shapes = [p for _, p in polys]
    if accents:
        shapes += [np.array([(x, y), (x + s, y), (x + s, y + s), (x, y + s)]) * 2
                   for x, y, s in ((10, 10, 64), (170, 140, 48))]
    assert not (diff & ~_within_2px_of_an_edge(diff.shape, shapes, factor)).any()


def test_visualizer_with_legend_matches_jax(synthetic):
    """Where matplotlib is installed the legend is drawn as the JAX package
    draws it (the same figure from the same pixels)."""
    pytest.importorskip("matplotlib")
    jslide, tslide, polys = synthetic
    want = np.asarray(jax_anno.AnnoVisualizer(
        jax_anno.AnnoDescription.with_known_colors(DEFAULT_COLORS),
    ).visualize(jslide, polys, max_side=300).convert("RGB"))
    got = port_anno.AnnoVisualizer(
        port_anno.AnnoDescription.with_known_colors(DEFAULT_COLORS),
    ).visualize(tslide, polys, max_side=300)
    np.testing.assert_array_equal(got, want)


def test_alpha_composite_is_pils():
    from PIL import Image

    from deephisto_tpu_torch.anno.visualize import alpha_composite

    rng = np.random.default_rng(0)
    dst = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    src = rng.integers(0, 256, (64, 80, 4), dtype=np.uint8)
    src[::3, :, 3] = 0
    src[1::5, :, 3] = 255
    want = Image.alpha_composite(Image.fromarray(dst).convert("RGBA"), Image.fromarray(src, "RGBA"))
    np.testing.assert_array_equal(alpha_composite(dst, src), np.asarray(want.convert("RGB")))
