"""The reference's class scores at chosen cells of a slide's downscale-16
class map, for the exact dense mode and the fcn mode, and the gap by which
a served class lies below the reference's best.

Exact dense mode: patches of ``ps``² at the dense coordinates (a stride
grid plus the last column, the last row and the corner); a map cell's
scores are the sum of the logits of every patch whose footprint
``[y//d, (y + ps)//d) × [x//d, (x + ps)//d)`` holds it.

fcn mode: the slide, edge-replicated, is cut into tiles of ``tile``² with
``halo`` pixels of context on each side; each tile's stride-32 features,
its halo cropped, go through the head into a logit map; a 32-aligned
window of ``ps``² has the mean of its 7×7 logits plus the head's bias; a
map cell holds the mean over the windows covering it, and cells past the
last window take the last covered cell's value.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_coords(h: int, w: int, ps: int = 224, stride: int = 112) -> np.ndarray:
    """(N, 2) int32 (y, x) patch corners of the exact dense mode."""
    coords = [(y, x) for y in range(0, h - ps, stride) for x in range(0, w - ps, stride)]
    coords += [(y, w - ps) for y in range(0, h - ps, stride)]
    coords += [(h - ps, x) for x in range(0, w - ps, stride)]
    coords.append((h - ps, w - ps))
    return np.asarray(coords, dtype=np.int32)


def _crops(slide: torch.Tensor, coords: np.ndarray, ps: int) -> torch.Tensor:
    return torch.stack([slide[y:y + ps, x:x + ps] for y, x in coords.tolist()])


def dense_cell_scores(slide: torch.Tensor, logits_fn, cells: np.ndarray, ps: int = 224,
                      stride: int = 112, d: int = 16, batch: int = 128) -> torch.Tensor:
    """(K, classes) float32 scores at (K, 2) map cells of an (H, W, 3)
    uint8 slide; ``logits_fn`` maps (B, ps, ps, 3) uint8 to (B, classes)."""
    h, w = slide.shape[:2]
    coords = dense_coords(h, w, ps, stride)
    y0, y1 = coords[:, 0] // d, (coords[:, 0] + ps) // d
    x0, x1 = coords[:, 1] // d, (coords[:, 1] + ps) // d
    members = [np.nonzero((y0 <= my) & (my < y1) & (x0 <= mx) & (mx < x1))[0]
               for my, mx in cells.tolist()]
    uniq = np.unique(np.concatenate(members))
    logits = torch.cat([logits_fn(_crops(slide, coords[uniq[i:i + batch]], ps))
                        for i in range(0, len(uniq), batch)])
    pos = {int(c): i for i, c in enumerate(uniq)}
    return torch.stack([logits[[pos[int(c)] for c in m]].sum(0) for m in members])


def _window_range(m: int, up: int, wf: int, k_valid: int) -> tuple[int, int]:
    """Window corners [lo, hi] covering map cell ``m`` on one axis (the
    cells past the last window take the last covered one's)."""
    i = min(m // up, k_valid + wf - 2)
    return max(0, i - wf + 1), min(i, k_valid - 1)


def fcn_cell_scores(slide: torch.Tensor, features_fn, fc_w: torch.Tensor, fc_b: torch.Tensor,
                    cells: np.ndarray, tile: int, halo: int, ps: int = 224, d: int = 16,
                    batch: int = 4) -> torch.Tensor:
    """(K, classes) float32 fcn scores at (K, 2) map cells; ``features_fn``
    maps (B, T, T, 3) uint8 tiles (T = tile + 2·halo) to their
    (B, T/32, T/32, C) float features."""
    fs = 32
    wf, up, ft, hh = ps // fs, fs // d, tile // fs, halo // fs
    h, w = slide.shape[:2]
    ty, tx = -(-h // tile), -(-w // tile)
    ky, kx = (h - ps) // fs + 1, (w - ps) // fs + 1
    ranges = [(_window_range(my, up, wf, ky), _window_range(mx, up, wf, kx))
              for my, mx in cells.tolist()]
    need = sorted({(r, c)
                   for (a, b), (e, f) in ranges
                   for r in range(a // ft, (b + wf - 1) // ft + 1)
                   for c in range(e // ft, (f + wf - 1) // ft + 1)})
    dev = slide.device
    nc = fc_w.shape[1]
    lmap = torch.full((ty * ft, tx * ft, nc), float("nan"), dtype=torch.float32, device=dev)
    side = tile + 2 * halo
    for i in range(0, len(need), batch):
        part = need[i:i + batch]
        tiles = []
        for r, c in part:
            rows = (torch.arange(side, device=dev) + r * tile - halo).clamp(0, h - 1)
            cols = (torch.arange(side, device=dev) + c * tile - halo).clamp(0, w - 1)
            tiles.append(slide.index_select(0, rows).index_select(1, cols))
        f = features_fn(torch.stack(tiles))[:, hh:hh + ft, hh:hh + ft]
        logits = f.float() @ fc_w
        for (r, c), lg in zip(part, logits):
            lmap[r * ft:(r + 1) * ft, c * ft:(c + 1) * ft] = lg
    win = torch.nn.functional.avg_pool2d(lmap.permute(2, 0, 1)[None], wf, 1)[0]
    win = win.permute(1, 2, 0)[:ky, :kx] + fc_b
    out = torch.stack([win[a:b + 1, e:f + 1].reshape(-1, nc).mean(0)
                       for (a, b), (e, f) in ranges])
    if not torch.isfinite(out).all():
        raise AssertionError("a sampled cell read a tile the reference did not compute")
    return out


def gaps(ref: torch.Tensor, chosen) -> torch.Tensor:
    """Per cell, the gap by which the reference's score of the chosen class
    lies below its best, as a share of the median spread (best minus worst)
    of the reference's scores over those cells. A class outside the
    reference's range reads as the spread plus one."""
    ref = ref.double().cpu()
    chosen = torch.as_tensor(np.asarray(chosen), dtype=torch.long)
    best, worst = ref.max(1).values, ref.min(1).values
    scale = float(torch.median(best - worst).clamp(min=1e-30))
    valid = chosen < ref.shape[1]
    got = ref.gather(1, chosen.clamp(max=ref.shape[1] - 1)[:, None])[:, 0]
    return torch.where(valid, best - got, best - worst + scale) / scale


def gap_numbers(ref: torch.Tensor, chosen) -> dict:
    """``map_gap``: the widest gap over the cells; ``map_gap_mean``: the
    mean gap, which near ties swing far less."""
    g = gaps(ref, chosen)
    return {"map_gap": float(g.max()), "map_gap_mean": float(g.mean())}
