"""Slide I/O: pyramidal gigapixel image backends (the port's copy of
``deephisto_tpu/slide``)."""

from pathlib import Path

from .array_slide import ArraySlide
from .base import Patch, Slide, build_pyramid
from .dhs import DHSlide, write_dhs
from .synthetic import (
    DEFAULT_CLASSES,
    DEFAULT_COLORS,
    make_synthetic_slide,
    star_polygon,
)

__all__ = [
    "ArraySlide",
    "DHSlide",
    "Patch",
    "Slide",
    "build_pyramid",
    "write_dhs",
    "make_synthetic_slide",
    "star_polygon",
    "DEFAULT_CLASSES",
    "DEFAULT_COLORS",
    "open_slide",
]


def open_slide(path) -> Slide:
    """Open an on-disk slide by path: ``.dhs`` → DHSlide; ``.psi`` →
    PSISlide when the psimage package imports, else raises with guidance
    (the psimage codec is not bundled)."""
    path = Path(path)
    if path.suffix == ".dhs":
        return DHSlide(path)
    if path.suffix == ".psi":
        from .psi import PSISlide, psimage_available

        if psimage_available():
            return PSISlide(path)
        raise NotImplementedError(
            "PSI codec requires the psimage package (not bundled); install it, "
            "or convert the slide to .dhs via "
            "deephisto_tpu_torch.slide.psi.convert_psi_to_dhs / write_dhs."
        )
    raise ValueError(f"unknown slide format: {path.suffix!r} ({path})")
