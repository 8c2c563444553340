"""Best-effort adapter for the reference's ``.psi`` format (psimage codec),
copied from ``deephisto_tpu/slide/psi.py``.

The psimage package is not bundled (and not installable in this environment),
but users migrating from the reference may have it. When importable, PSISlide
wraps a ``psimage.PSImage`` behind this framework's Slide surface so every
sampler/predictor works on real ``.psi`` data unchanged; ``convert_psi_to_dhs``
re-encodes a slide into the native DHS format for mmap-speed reads.

Untestable here (no psimage, no data); the surface mirrors exactly the calls
the reference makes: ``layer_size`` (region_samplers.py:229),
``get_region_from_layer`` (:513-520), ``get_region(target_hw=)``
(predict_full_patched.py:104), ``to_image`` (anno/utils.py:295; returned
as an (h, w, 3) uint8 array, as the port's ``Slide.to_image`` returns it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .base import Slide


def psimage_available() -> bool:
    try:
        import psimage  # noqa: F401

        return True
    except ImportError:
        return False


class PSISlide(Slide):
    """A ``.psi`` slide exposed through the port's Slide surface."""

    def __init__(self, path: Path | str):
        from psimage import PSImage

        self.path = Path(path)
        self._psim = PSImage(self.path)
        self.height = int(self._psim.height)
        self.width = int(self._psim.width)
        layers = []
        l = 1
        while True:
            try:
                self._psim._assert_layer(l)
                layers.append(l)
                l *= 2
            except Exception:
                break
        self.layers = tuple(layers) if layers else (1,)

    def layer_size(self, layer: int) -> tuple[int, int]:
        return tuple(self._psim.layer_size(layer))

    def get_region_from_layer(self, layer, tl, br) -> np.ndarray:
        return np.asarray(
            self._psim.get_region_from_layer(layer, tuple(tl), tuple(br))
        )

    def get_region(self, tl, br, target_hw=None) -> np.ndarray:
        return np.asarray(self._psim.get_region(tl, br, target_hw=target_hw))

    def to_image(self, max_side=None, scale=None, auto_downscale=False, **kw):
        return np.asarray(self._psim.to_image(
            max_side=max_side, scale=scale, auto_downscale=auto_downscale
        ).convert("RGB"), dtype=np.uint8)

    def close(self) -> None:
        self._psim.close()


def convert_psi_to_dhs(psi_path: Path | str, out_path: Path | str | None = None):
    """Re-encode a ``.psi`` slide as DHS (memory-mappable raw layers)."""
    from .dhs import write_dhs

    with PSISlide(psi_path) as s:
        level0 = s.get_region_from_layer(1, (0, 0), (s.height, s.width))
        max_layer = max(s.layers)
    out = Path(out_path) if out_path else Path(psi_path).with_suffix(".dhs")
    return write_dhs(level0, out, max_layer=max_layer)
