"""Seeded slides, the order a cohort sends them in and each request's own
block of bytes. Every function is a pure function of ``--seed`` and its
arguments, so the check regenerates any request's slide after the window.

A slide is uniform noise on [0, 128) over a grid of random block colours
on [0, 128) (``block_px`` pixels a side), so the class map has structure
to agree on; it is made on the device in a few large calls and copied to
host memory, where a loader would hold it. Before request ``i`` is sent,
one ``side``² block of it at a seeded place is overwritten with seeded
bytes (and put back after the answer), so no two requests send the same
bytes."""

from __future__ import annotations

import numpy as np
import torch

from ...core.seeds import derive


def make_slide(seed: int, index: int, h: int, w: int, block_px: int, device) -> torch.Tensor:
    """(h, w, 3) uint8 on ``device``: slide ``index`` of the seed's pool."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "slide", index))
    out = torch.randint(0, 128, (h, w, 3), dtype=torch.uint8, device=device, generator=gen)
    gh, gw = -(-h // block_px), -(-w // block_px)
    blocks = torch.randint(0, 128, (gh, gw, 3), dtype=torch.uint8, device=device, generator=gen)
    rows = blocks.repeat_interleave(block_px, 0)[:h]
    for x0 in range(0, w, block_px):  # one column of blocks at a time: no full-size temporary
        x1 = min(w, x0 + block_px)
        out[:, x0:x1] += rows[:, x0 // block_px, None, :]
    return out


def order(seed: int, n_sizes: int, n: int) -> np.ndarray:
    """The size index of requests 0..n-1: successive seeded permutations of
    the multiset, so every seed sends every size once a cycle."""
    rng = np.random.default_rng(derive(seed, "order"))
    cycles = -(-n // n_sizes)
    return np.concatenate([rng.permutation(n_sizes) for _ in range(cycles)])[:n]


def request_block(seed: int, i: int, h: int, w: int, side: int):
    """(y, x, (side, side, 3) uint8) of request ``i`` on an (h, w) slide."""
    rng = np.random.default_rng(derive(seed, "block", i))
    y = int(rng.integers(0, h - side + 1))
    x = int(rng.integers(0, w - side + 1))
    return y, x, rng.integers(0, 256, (side, side, 3), dtype=np.uint8)


def request_slide(seed: int, rec: dict, traffic: dict, device) -> torch.Tensor:
    """The slide request ``rec`` sent, made again on ``device``."""
    h, w = rec["h"], rec["w"]
    s = make_slide(seed, rec["size"], h, w, traffic["block_px"], device)
    y, x, blk = request_block(seed, rec["i"], h, w, traffic["request_block"])
    s[y:y + blk.shape[0], x:x + blk.shape[1]] = torch.from_numpy(blk).to(device)
    return s
