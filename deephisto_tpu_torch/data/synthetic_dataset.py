"""Materialize a synthetic dataset in the reference's on-disk layout
(copied from ``deephisto_tpu/data/synthetic_dataset.py``; the port's slides
are filled without PIL, see slide/synthetic.py).

The reference expects ``<ds>/images/{train,test}/*.psi`` plus
``<ds>/annotations/{train,test}/<stem>.json`` (reference utils.py:4-14).
We produce the same tree with ``.dhs`` slides so every CLI entry point runs
end-to-end without the unavailable PATH-DT-MSU data.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..slide.dhs import write_dhs
from ..slide.synthetic import make_synthetic_slide


def ensure_synthetic_dataset(
    ds_folder: Path | str,
    n_train: int = 2,
    n_test: int = 1,
    height: int = 2048,
    width: int = 2048,
    seed: int = 42,
    max_layer: int = 8,
    hard: bool = False,
) -> Path:
    """Create (idempotently) a synthetic dataset tree and return its root.

    Slides are seeded deterministically: slide k of split s uses
    ``seed + hash(s) + k`` so re-running yields identical data.
    """
    ds_folder = Path(ds_folder)
    marker = ds_folder / ".synthetic_complete.json"
    want = {
        "n_train": n_train,
        "n_test": n_test,
        "height": height,
        "width": width,
        "seed": seed,
        "max_layer": max_layer,
        "hard": hard,
    }
    if marker.is_file() and json.loads(marker.read_text()) == want:
        return ds_folder

    for split, count, split_off in (("train", n_train, 0), ("test", n_test, 1000)):
        img_dir = ds_folder / "images" / split
        anno_dir = ds_folder / "annotations" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        anno_dir.mkdir(parents=True, exist_ok=True)
        for k in range(count):
            stem = f"{split}_{k:02d}"
            slide, annos = make_synthetic_slide(
                seed=seed + split_off + k,
                height=height,
                width=width,
                max_layer=max_layer,
                hard=hard,
            )
            write_dhs(slide._pyramid[1], img_dir / f"{stem}.dhs", max_layer=max_layer)
            (anno_dir / f"{stem}.json").write_text(json.dumps(annos))

    marker.write_text(json.dumps(want))
    return ds_folder
