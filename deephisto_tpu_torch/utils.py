"""Dataset path resolution, copied from ``deephisto_tpu/utils.py`` (mirror of
reference utils.py:1-14, extended to the DHS format and with a
synthetic-dataset fallback for missing datasets)."""

from __future__ import annotations

from pathlib import Path

SLIDE_SUFFIXES = (".dhs", ".psi")


def get_img_ano_paths(
    ds_folder: Path | str, sample: str = "train"
) -> list[tuple[Path, Path]]:
    """List (slide, annotation) path pairs for a dataset split.

    Matches reference utils.py:4-14: slides live in ``<ds>/images/<sample>``,
    annotations in ``<ds>/annotations/<sample>/<stem>.json``.
    """
    ds_folder = Path(ds_folder)
    img_paths = sorted(
        p
        for p in (ds_folder / "images" / sample).iterdir()
        if p.suffix in SLIDE_SUFFIXES and (p.is_file() or p.is_dir())
    )
    anno_paths = [
        ds_folder / "annotations" / sample / f"{p.stem}.json" for p in img_paths
    ]
    return list(zip(img_paths, anno_paths))


def resolve_dataset(ds_folder: Path | str, **synthetic_kwargs) -> Path:
    """Return ``ds_folder`` if it exists, else materialize the synthetic
    dataset there (so every entry point runs without real data)."""
    ds_folder = Path(ds_folder)
    if (ds_folder / "images").is_dir() and not (
        ds_folder / ".synthetic_complete.json"
    ).is_file():
        return ds_folder
    from .data.synthetic_dataset import ensure_synthetic_dataset

    return ensure_synthetic_dataset(ds_folder, **synthetic_kwargs)
