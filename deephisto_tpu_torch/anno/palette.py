"""Distinct color palette generation (dependency-free distinctipy stand-in),
copied from ``deephisto_tpu/anno/palette.py``: the same colours for the same
``rng``.

The reference delegates to ``distinctipy.get_colors`` (reference
anno/utils.py:180-185). We reproduce the same contract — avoid the supplied
exclude colors, optional pastel bias, deterministic under a seed — with greedy
farthest-point sampling in RGB space over a seeded candidate cloud.
"""

from __future__ import annotations

import numpy as np

# colors every palette should stay away from, like distinctipy's defaults
_BASE_AVOID = np.array(
    [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]], dtype=np.float64
)


def get_distinct_colors(
    n: int,
    exclude: list[tuple[float, float, float]] | None = None,
    pastel_factor: float = 0.0,
    rng: int | None = None,
) -> list[tuple[float, float, float]]:
    """Generate ``n`` mutually-distinct RGB colors in [0, 1]^3.

    Greedy farthest-point: each new color maximizes its minimum Euclidean
    distance to all previously chosen + excluded colors over a random
    candidate cloud (deterministic given ``rng``).
    """
    if n <= 0:
        return []
    gen = np.random.default_rng(rng)
    chosen = _BASE_AVOID.copy()
    if exclude:
        chosen = np.concatenate([chosen, np.asarray(exclude, dtype=np.float64)], axis=0)
    out = []
    for _ in range(n):
        cands = gen.uniform(0, 1, size=(512, 3))
        if pastel_factor > 0:
            cands = (cands + pastel_factor) / (1.0 + pastel_factor)
        d = np.linalg.norm(cands[:, None, :] - chosen[None, :, :], axis=2).min(axis=1)
        best = cands[np.argmax(d)]
        chosen = np.concatenate([chosen, best[None]], axis=0)
        out.append(tuple(best))
    return out


class Palette:
    """Palette of distinct uint8 RGB colors (mirror of reference
    anno/utils.py:143-190: known colors kept, missing ones generated)."""

    def __init__(
        self,
        colors: tuple[tuple[int, int, int], ...] | None = None,
        n_colors_max: int | None = None,
        rng: int | None = None,
    ) -> None:
        if colors is not None:
            for color in colors:
                if not all(0 <= c <= 255 for c in color):
                    raise RuntimeError("Color values must be between 0 and 255.")
        if (
            n_colors_max is not None
            and colors is not None
            and n_colors_max < len(colors)
        ):
            raise RuntimeError("n_colors_max must be >= number of defined colors.")
        n_colors_max = len(colors) if n_colors_max is None else n_colors_max
        self.colors: list[tuple[int, int, int]] = list(colors) if colors else []

        additional = get_distinct_colors(
            n_colors_max - len(self.colors),
            exclude=[(c[0] / 255, c[1] / 255, c[2] / 255) for c in self.colors],
            pastel_factor=0.1,
            rng=rng,
        )
        self.colors.extend(
            (int(r * 255), int(g * 255), int(b * 255)) for r, g, b in additional
        )
