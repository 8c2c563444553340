"""Annotation visualization: polygon overlays, patch accents, legend — a port
of ``deephisto_tpu/anno/visualize.py`` (reference anno/utils.py:193-408)
without PIL.

The polygons are rasterized on the host onto an RGBA overlay by a port of
PIL's own routines (``ImagingDrawPolygon``: vertices truncated to ints, the
scanline fill with float32 crossings, both in ``geometry/raster.py``; 1-px
Bresenham lines, wide lines as filled quadrilaterals), each pixel overwritten as ``ImageDraw`` overwrites
it: the fill in the class colour at the fill transparency, then the outline
in the opaque colour, a wide one kept inside the fill as PIL masks it. The
overlay is composited with PIL's integer ``alpha_composite`` formula. The
legend needs matplotlib and is drawn only where it is installed.
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass

import numpy as np

from ..geometry.raster import (_edge, _fill_edges, _int_vertices, _polygon_fill, _round_down,
                               _round_up)
from .classes import AnnoDescription


@dataclass
class AnnoVisualizerParams:
    fill: bool
    fill_transparency: float
    line_width: int
    show_legend: bool
    legend_placement: str | None
    legend_size: int | None

    @classmethod
    def default(cls) -> "AnnoVisualizerParams":
        return cls(
            fill=True,
            fill_transparency=0.3,
            line_width=2,
            show_legend=True,
            legend_placement="TR",
            legend_size=20,
        )

    @classmethod
    def no_legend(cls) -> "AnnoVisualizerParams":
        return cls(
            fill=True,
            fill_transparency=0.3,
            line_width=2,
            show_legend=False,
            legend_placement=None,
            legend_size=None,
        )


@dataclass
class PatchVisAccent:
    """A highlighted patch rectangle; coordinates are layer coordinates and get
    scaled back by ``layer`` when drawn (reference anno/utils.py:353-357)."""

    layer: int
    size: int
    x: int
    y: int
    label: str | None = None

    @classmethod
    def parse(cls, code_str: str, layer: int, patch_s: int) -> "PatchVisAccent":
        # e.g. "r28_LP_7_x17311_y14066"
        s = code_str.split("_")
        return cls(layer=layer, size=patch_s, x=int(s[3][1:]), y=int(s[4][1:]), label=s[1])


def _line(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """PIL's 1-px ``line``: Bresenham from (x0, y0), the last point left to
    the next segment."""
    h, w = mask.shape
    dx, xs = abs(x1 - x0), (1 if x1 >= x0 else -1)
    dy, ys = abs(y1 - y0), (1 if y1 >= y0 else -1)
    pts = []
    if dx == 0 or dy == 0:
        for _ in range(max(dx, dy)):
            pts.append((x0, y0))
            x0, y0 = x0 + (xs if dy == 0 else 0), y0 + (ys if dx == 0 else 0)
    elif dx > dy:
        e = 2 * dy - dx
        for _ in range(dx):
            pts.append((x0, y0))
            if e >= 0:
                y0, e = y0 + ys, e - 2 * dx
            e, x0 = e + 2 * dy, x0 + xs
    else:
        e = 2 * dx - dy
        for _ in range(dy):
            pts.append((x0, y0))
            if e >= 0:
                x0, e = x0 + xs, e - 2 * dy
            e, y0 = e + 2 * dx, y0 + ys
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = True


def _wide_line(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int, width: int) -> None:
    """PIL's ``ImagingDrawWideLine``: the line's quadrilateral, filled."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        if 0 <= y0 < mask.shape[0] and 0 <= x0 < mask.shape[1]:
            mask[y0, x0] = True
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    r_max, r_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(r_min * dy), _round_down(r_max * dy)
    dymin, dymax = _round_down(r_min * dx), _round_down(r_max * dx)
    v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
         (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
    _fill_edges(mask, [_edge(*v[i], *v[(i + 1) % 4]) for i in range(4)])


def _outline(ixy: list[tuple[int, int]], h: int, w: int, width: int) -> np.ndarray:
    """PIL's polygon outline as an (h, w) mask: 1-px lines, or wide lines
    of ``width`` px."""
    mask = np.zeros((h, w), dtype=bool)
    for (x0, y0), (x1, y1) in zip(ixy, ixy[1:] + ixy[:1]):
        if width == 1:
            _line(mask, x0, y0, x1, y1)
        else:
            _wide_line(mask, x0, y0, x1, y1, width)
    return mask


def _draw_polygon(overlay: np.ndarray, vertices, outline, width: int, fill) -> None:
    """Draw a polygon on an (h, w, 4) uint8 RGBA overlay as PIL's
    ``ImageDraw.polygon(vertices, outline=, width=, fill=)`` does on an RGBA
    image: the fill, then the outline, each overwriting its pixels; an
    outline wider than 1 is a line of 2·width - 1 px kept inside the fill."""
    h, w = overlay.shape[:2]
    ixy = _int_vertices(vertices)
    inside = _polygon_fill(ixy, h, w)
    overlay[inside] = fill
    if width == 1:
        edge = _outline(ixy, h, w, 1)
    else:
        edge = inside & _outline(ixy, h, w, 2 * width - 1)
    overlay[edge] = outline


def alpha_composite(dst_rgb: np.ndarray, src_rgba: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst.convert("RGBA"), src).convert("RGB")``
    in PIL's integer arithmetic (7 bits of precision, division by 255 by
    shifts) for an opaque destination."""
    dst = dst_rgb.astype(np.int64)
    src = src_rgba[..., :3].astype(np.int64)
    sa = src_rgba[..., 3:].astype(np.int64)
    # PIL: coef1 = sa·255·255·128 / outa255 with outa255 = 255·255 when
    # dst is opaque, so coef1 = sa·128 and coef2 = (255 - sa)·128
    tmp = src * (sa << 7) + dst * ((255 - sa) << 7) + (0x80 << 7)
    out = ((((tmp >> 8) + tmp) >> 8) >> 7).astype(np.uint8)
    return np.where(sa == 0, dst_rgb, out)


class AnnoVisualizer:
    """Draw polygonal annotations (and optional patch accents) on a downscaled
    slide preview."""

    def __init__(
        self,
        anno_description: AnnoDescription,
        vis_params: AnnoVisualizerParams | None = None,
    ) -> None:
        self.anno_description = anno_description
        self.vis_params = vis_params or AnnoVisualizerParams.default()

    def visualize(
        self,
        slide,
        polygon_annotations: list[tuple[str, np.ndarray]],
        scale: float | None = None,
        max_side: int | None = None,
        auto_downscale: bool = False,
        patch_accents: list[PatchVisAccent] | None = None,
    ) -> np.ndarray:
        """Render annotations onto a preview of ``slide`` (a Slide object) →
        (h, w, 3) uint8, where the JAX package returns a PIL image.

        ``polygon_annotations`` is a list of (label, vertices_xy) pairs in
        full-resolution coordinates.
        """
        vp = self.vis_params
        img = slide.to_image(max_side=max_side, scale=scale, auto_downscale=auto_downscale)
        overlay = np.zeros(img.shape[:2] + (4,), dtype=np.uint8)
        downscale_factor = (img.shape[0] / slide.height + img.shape[1] / slide.width) / 2
        fill_transparency = int(255 * vp.fill_transparency) if vp.fill else 0

        for lbl, poly in polygon_annotations:
            color = tuple(self.anno_description.color_by_label(lbl))
            vertices = [
                (float(x) * downscale_factor, float(y) * downscale_factor)
                for x, y in np.asarray(poly)
            ]
            _draw_polygon(overlay, vertices, color + (255,), vp.line_width,
                          color + (fill_transparency,))

        if patch_accents is not None:
            self._add_patch_accents(overlay, downscale_factor, patch_accents)

        img_final = alpha_composite(img, overlay)
        if vp.show_legend:
            img_final = self._add_legend(img_final)
        return img_final

    def _add_patch_accents(self, overlay, downscale_factor, patch_accents):
        vp = self.vis_params
        fill_transparency = int(255 * vp.fill_transparency) if vp.fill else 0
        fill_transparency = min(255, fill_transparency + 80)
        for pa in patch_accents:
            color = tuple(self.anno_description.color_by_label(pa.label))
            color = (
                min(255, color[0] + 20),
                max(0, color[1] - 10),
                min(255, color[2] + 10),
            )
            x = pa.layer * pa.x * downscale_factor
            y = pa.layer * pa.y * downscale_factor
            s = pa.layer * pa.size * downscale_factor
            _draw_polygon(overlay, [(x, y), (x + s, y), (x + s, y + s), (x, y + s)],
                          color + (255,), 1, color + (fill_transparency,))

    def _add_legend(self, img: np.ndarray, dpi: int = 100) -> np.ndarray:
        """The image with the class legend drawn over it by matplotlib, or
        as it is where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return img
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        from matplotlib.patches import Rectangle

        from .._imageio import decode_png

        fig = plt.figure(figsize=(img.shape[1] / dpi, img.shape[0] / dpi))
        ax = fig.add_axes([0, 0, 1, 1])
        ax.axis("off")
        plt.imshow(img)
        legend_data = [
            (c.color, c.label_full) for c in self.anno_description.anno_classes
        ]
        handles = [
            Rectangle((0, 0), 1, 1, color=[v / 255 for v in c])
            for c, _ in legend_data
        ]
        labels = [lbl for _, lbl in legend_data]
        legend_loc = {
            "TL": "upper left",
            "TR": "upper right",
            "BR": "lower right",
            "BL": "lower left",
        }[self.vis_params.legend_placement]
        plt.legend(handles, labels, loc=legend_loc, prop={"size": self.vis_params.legend_size})

        buf = io.BytesIO()
        plt.savefig(buf, format="png")
        plt.close(fig)
        return decode_png(buf.getvalue())
