"""Slide I/O: pyramidal gigapixel image backends (the port's copy of
``deephisto_tpu/slide``, without the .psi backend)."""

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
    """Open an on-disk slide by path: ``.dhs`` → DHSlide. ``.psi`` (the
    external psimage codec) is not ported."""
    path = Path(path)
    if path.suffix == ".dhs":
        return DHSlide(path)
    if path.suffix == ".psi":
        raise NotImplementedError(
            "the port reads .dhs slides only; convert .psi slides with the JAX "
            "package (deephisto_tpu.slide.psi.convert_psi_to_dhs)"
        )
    raise ValueError(f"unknown slide format: {path.suffix!r} ({path})")
