"""Area-based sampling weight machinery (copied from
``deephisto_tpu/samplers/weights.py``).

Closed-form port of the reference's weight computation (reference
region_samplers.py:339-482): ``area_weights`` interpolates between uniform,
area-proportional, and inverse-area-proportional weighting by
``area_influence ∈ [-1, 1]``, and ``calc_weights`` builds the four weight sets
the random region sampler consumes:

  1. per-class region weights over all images,
  2. per-image per-class region weights,
  3. per-class image weights (area share of that class per image),
  4. all-image weights (total annotated area per image).
"""

from __future__ import annotations

import numpy as np

from ..anno.parse import RegionAnnotation


def area_weights(areas, area_influence: float) -> np.ndarray:
    """Weights for regions given their areas (reference region_samplers.py:339-378).

    area_influence = 0 → uniform; > 0 → blend toward area-proportional;
    < 0 → blend toward inverse-area-proportional. Always normalized to sum 1.
    """
    assert -1 <= area_influence <= 1
    areas = np.asarray(areas, dtype=np.float64)
    n = len(areas)
    w_default = np.full(n, 1.0 / n) if n else np.zeros(0)
    if area_influence == 0 or n == 0 or areas.sum() <= 0 or (areas <= 0).any():
        # degenerate inputs (empty, zero or non-positive areas) fall back to
        # uniform — proportional/inverse blending is undefined for them
        return w_default
    if area_influence > 0:
        w_prop = areas / areas.sum()
        w = w_default + (w_prop - w_default) * area_influence
    else:
        inv = 1.0 / areas
        w_inv = inv / inv.sum()
        w = w_default + (w_inv - w_default) * (-area_influence)
    return w / w.sum()


def calc_weights(
    regions: dict[str, list[RegionAnnotation]],
    regions_per_image: list[dict[str, list[RegionAnnotation]]],
    classes: list[str],
    region_area_influence: float,
) -> tuple[
    dict[str, np.ndarray],
    list[dict[str, np.ndarray]],
    dict[str, np.ndarray],
    np.ndarray,
]:
    """The four weight sets of reference region_samplers.py:395-482."""
    reg_weights_all = {
        cls: area_weights([r.area for r in reg], region_area_influence)
        for cls, reg in regions.items()
    }

    reg_weights_per_img = [
        {
            cls: area_weights([r.area for r in reg], region_area_influence)
            for cls, reg in rpi.items()
        }
        for rpi in regions_per_image
    ]

    img_weights = {}
    for cls in classes:
        a = np.array(
            [
                sum(r.area for r in rpi.get(cls, []))
                for rpi in regions_per_image
            ]
        )
        total = a.sum()
        # degenerate (no area anywhere) → uniform; the sampler rejects empty
        # datasets downstream with a clear error
        img_weights[cls] = a / total if total > 0 else np.full_like(
            a, 1.0 / max(len(a), 1), dtype=np.float64
        )

    all_regs_areas_per_image = [
        sum(sum(r.area for r in lst) for lst in rpi.values())
        for rpi in regions_per_image
    ]
    img_weights_all = area_weights(all_regs_areas_per_image, region_area_influence)

    return reg_weights_all, reg_weights_per_img, img_weights, img_weights_all
