"""Annotation parsing: JSON region files → host region records (copied
from ``deephisto_tpu/anno/parse.py``).

Mirrors the reference's ``RegionAnnotation`` + ``_parse_annotations``
(reference region_samplers.py:18-249) with the shapely dependency replaced by
the geometry engine. Validation semantics match: vertices must be (N, 2)
float64 (region_samplers.py:64-67), vertices are rescaled by ``1/layer``
(:68), invalid polygons are reported and repaired-on-a-best-effort basis
(:69-71), failing regions are skipped and counted (:235-239).
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..geometry import is_simple_polygon, polygon_bounds, repair_polygon, shoelace_area
from ..slide import Slide, open_slide


@dataclass
class RegionAnnotation:
    """One annotated polygon on one slide, in layer coordinates."""

    file_path: Path
    region_idx: int
    class_: str
    vertices: np.ndarray  # original layer-1 (x, y) float64, as in the JSON
    layer: int = 1
    layer_size: tuple[int, int] = (0, 0)
    # derived
    vertices_layer: np.ndarray = field(default=None, repr=False)
    area: float = 0.0
    bounds: tuple[float, float, float, float] = (0, 0, 0, 0)  # x0, y0, x1, y1
    image_idx: int = -1

    def __post_init__(self):
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 2:
            raise RuntimeError("Invalid region shape. It should be (N, 2).")
        if self.vertices.dtype != np.float64:
            raise RuntimeError("Invalid region dtype. It should be float64.")
        v = self.vertices if self.layer == 1 else self.vertices / self.layer
        if not is_simple_polygon(v):
            # real repair, like the reference's shapely buffer(0)
            # (region_samplers.py:69-71): split self-crossings into simple
            # loops, keep the dominant-orientation ones (drops accidental
            # bowtie slivers), keyhole-bridge the rest back into one ring
            print("invalid polygon found. Fixing...")
            v = repair_polygon(v)
        self.vertices_layer = np.ascontiguousarray(v)
        self.area = shoelace_area(v)
        self.bounds = polygon_bounds(v)

    def __str__(self) -> str:
        return (
            f"Region [{self.file_path.stem}, {self.region_idx}, "
            f"{self.class_}, {self.vertices.shape}, {round(self.area, 0)}]"
        )


def parse_annotations(
    img_anno_paths: list[tuple[Path, Path]],
    layer: int,
    classes: list[str] | None = None,
    verbose: bool = True,
) -> tuple[dict[str, list[RegionAnnotation]], list[dict[str, list[RegionAnnotation]]]]:
    """Parse all (slide, annotation) pairs into per-class region lists.

    Returns (regions_all, regions_per_image) exactly like the reference
    (region_samplers.py:194-249): a class→regions dict over all images plus a
    per-image list of such dicts. Failing regions are skipped and counted.
    """
    regions_all: dict[str, list[RegionAnnotation]] = defaultdict(list)
    regions_per_image: list[dict[str, list[RegionAnnotation]]] = [
        defaultdict(list) for _ in img_anno_paths
    ]
    regions_failed = 0
    for j, (img_path, anno_path) in enumerate(img_anno_paths):
        with open_slide(img_path) as slide:
            layer_size = slide.layer_size(layer)
        for i, a in enumerate(json.loads(Path(anno_path).read_text())):
            cls = a["class"]
            if classes is not None and cls not in classes:
                continue
            try:
                reg = RegionAnnotation(
                    file_path=Path(img_path),
                    region_idx=i,
                    class_=cls,
                    vertices=np.array(a["vertices"], dtype=np.float64),
                    layer=layer,
                    layer_size=layer_size,
                    image_idx=j,
                )
                regions_per_image[j][cls].append(reg)
                regions_all[cls].append(reg)
            except Exception:
                regions_failed += 1

    if verbose:
        if regions_failed > 0:
            print(f"Failed to parse {regions_failed} regions.")
        counts = {cls: len(r) for cls, r in regions_all.items()}
        print(f"regions all: {counts}")
        print("regions per image:")
        for i, rpi in enumerate(regions_per_image):
            counts = {cls: len(r) for cls, r in rpi.items()}
            print(f"\timage {i}: {counts}")

    return dict(regions_all), [dict(r) for r in regions_per_image]
