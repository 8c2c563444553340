"""Seeded synthetic slide + annotation generator, copied from
``deephisto_tpu/slide/synthetic.py`` with one change: polygons are filled by
the port's numpy scanline fill (``geometry/raster.py``), not PIL, which the
machine with the card lacks. Slides therefore differ from the JAX package's
at polygon outlines; the annotations are the same.

The reference has no test fixtures and depends on the unavailable PATH-DT-MSU
datasets (reference models/patch_cls_simple/config.yaml:21,
examples/sample_annotated_rnd.py:27). This module is the fake backend the
reference never had (SURVEY.md §4): it procedurally generates a
histology-looking slide plus polygonal class annotations in the exact JSON
contract the reference parses (``[{"class": str, "vertices": [[x, y], ...]}]``
with float vertices in layer-1 coordinates — reference
region_samplers.py:218-227).

Determinism: everything derives from a single integer seed.
"""

from __future__ import annotations

import numpy as np

from ..geometry.raster import polygon_mask
from .array_slide import ArraySlide

# Canonical 5-class setup of the reference datasets
# (reference examples/predict_full_patched.py:140-149).
DEFAULT_CLASSES = ("AT", "BG", "LP", "MM", "TUM")

DEFAULT_COLORS = {
    "AT": (245, 119, 34),
    "BG": (153, 255, 255),
    "LP": (64, 170, 72),
    "MM": (255, 0, 0),
    "TUM": (33, 67, 156),
}

# Base tissue tints per class — distinct enough that a small conv net can
# learn them, noisy enough that the problem isn't trivial.
_CLASS_TINTS = {
    "AT": (232, 180, 200),
    "BG": (244, 242, 244),
    "LP": (190, 140, 190),
    "MM": (150, 100, 160),
    "TUM": (120, 70, 140),
}


def star_polygon(
    rng: np.random.Generator,
    center: tuple[float, float],
    radius: float,
    n_vertices: int,
    irregularity: float = 0.45,
) -> np.ndarray:
    """Random star-convex (hence simple / non-self-intersecting) polygon.

    Returns (V, 2) float64 vertices as (x, y) pairs, matching the annotation
    JSON vertex order used by the reference (x first: region_samplers.py:116 uses
    ``polygon.bounds`` as x0, y0, x1, y1).
    """
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n_vertices))
    radii = radius * (1.0 - irregularity + irregularity * rng.uniform(0, 2, size=n_vertices))
    cx, cy = center
    xs = cx + radii * np.cos(angles)
    ys = cy + radii * np.sin(angles)
    return np.stack([xs, ys], axis=1).astype(np.float64)


# Hard-mode class signatures: identical base tint for every class — class
# identity is carried ONLY by texture statistics (speckle density / speckle
# radius / lighting frequency), so a model must learn spatial features, not a
# color lookup. Used by the time-to-accuracy study (benchmarks/
# time_to_accuracy.py): the easy tints saturate any backbone in a few epochs,
# which made backbone comparisons unreadable (VERDICT r2 "What's weak" #1).
_HARD_TINT = (205, 162, 188)
_HARD_DENSITY = {"AT": 1.0e-3, "BG": 1.5e-3, "LP": 2.2e-3, "MM": 3.3e-3, "TUM": 5.0e-3}
_HARD_SPOT_R = {"AT": 2, "BG": 1, "LP": 2, "MM": 1, "TUM": 2}


def _class_texture(
    rng: np.random.Generator, cls: str, h: int, w: int, hard: bool = False
) -> np.ndarray:
    """Per-class texture field: tinted base + multi-scale noise + class-specific
    'nuclei' speckle frequency. ``hard=True`` removes the color cue entirely
    (shared tint; see _HARD_TINT block comment)."""
    base = np.array(_HARD_TINT if hard else _CLASS_TINTS[cls], dtype=np.float32)
    img = np.broadcast_to(base, (h, w, 3)).copy()
    # low-frequency lighting variation
    yy = np.linspace(0, 2 * np.pi * rng.uniform(0.5, 2.0), h, dtype=np.float32)
    xx = np.linspace(0, 2 * np.pi * rng.uniform(0.5, 2.0), w, dtype=np.float32)
    wave = np.float32(10.0) * np.outer(
        np.sin(yy + np.float32(rng.uniform(0, 6))),
        np.cos(xx + np.float32(rng.uniform(0, 6))),
    )
    img += wave[..., None]
    # white-noise grain — float32 end-to-end (float64 here costs gigabytes of
    # allocation+conversion on gigapixel slides)
    noise = rng.standard_normal(size=(h, w, 3), dtype=np.float32)
    noise *= np.float32(9.0)
    img += noise
    # class-specific speckle: darker blobs with density keyed to the class index
    if hard:
        density = _HARD_DENSITY[cls]
        r = _HARD_SPOT_R[cls]
    else:
        density = {"AT": 4e-4, "BG": 2e-5, "LP": 1.2e-3, "MM": 2.5e-3, "TUM": 4e-3}[cls]
        r = 1
    n_spots = int(h * w * density)
    if n_spots:
        sy = rng.integers(r, h - r, size=n_spots)
        sx = rng.integers(r, w - r, size=n_spots)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                img[sy + dy, sx + dx] -= 55.0 if not hard else 40.0
    return np.clip(img, 0, 255).astype(np.uint8)


def rasterize_polygon_mask(vertices_xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """Boolean mask of pixels inside the polygon (numpy scanline fill; used
    only for image *generation*, not for sampling decisions)."""
    return polygon_mask(vertices_xy, h, w)


def make_synthetic_slide(
    seed: int,
    height: int = 2048,
    width: int = 2048,
    classes: tuple[str, ...] = DEFAULT_CLASSES,
    regions_per_class: tuple[int, int] = (2, 4),
    radius_frac: tuple[float, float] = (0.08, 0.2),
    max_layer: int = 8,
    hard: bool = False,
) -> tuple[ArraySlide, list[dict]]:
    """Generate a synthetic annotated slide.

    Returns (slide, annotations) where annotations follow the reference JSON
    contract: a list of {"class": str, "vertices": [[x, y], ...]} in layer-1
    coordinates.
    """
    rng = np.random.default_rng(seed)
    h, w = int(height), int(width)

    # background: pale histology slide glass
    img = np.full((h, w, 3), 0, dtype=np.uint8)
    bg = _class_texture(rng, "BG", h, w, hard=hard)
    img[:] = bg

    annotations: list[dict] = []
    min_side = min(h, w)
    for cls in classes:
        n_regions = int(rng.integers(regions_per_class[0], regions_per_class[1] + 1))
        tex = _class_texture(rng, cls, h, w, hard=hard)
        for _ in range(n_regions):
            radius = rng.uniform(*radius_frac) * min_side
            margin = radius * 1.1
            cx = rng.uniform(margin, w - margin)
            cy = rng.uniform(margin, h - margin)
            poly = star_polygon(rng, (cx, cy), radius, n_vertices=int(rng.integers(8, 16)))
            np.clip(poly[:, 0], 0, w - 1, out=poly[:, 0])
            np.clip(poly[:, 1], 0, h - 1, out=poly[:, 1])
            mask = rasterize_polygon_mask(poly, h, w)
            img[mask] = tex[mask]
            annotations.append({"class": cls, "vertices": poly.tolist()})

    return ArraySlide(img, max_layer=max_layer), annotations
