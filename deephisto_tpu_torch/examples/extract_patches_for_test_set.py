"""Example of preparing patches for a test set (mirror of reference
examples/extract_patches_for_test_set.py; flags default to its hardcoded
values). The patches are JPEG files written by Pillow
(``extract_and_save_subset``), as the JAX package writes them."""

import argparse
from pathlib import Path

from ..samplers import extract_and_save_subset
from ..utils import get_img_ano_paths
from ._dataset import example_dataset


def extract_patches_for_test_set(layer: int = 2, patch_size: int = 224,
                                 patches_per_class: int = 100, device=None) -> Path:
    """Extract up to ``patches_per_class`` patches a class from the test
    slides into ``<dataset>/patches_test``; returns that folder."""
    ds = example_dataset()
    out_dir = Path(ds) / "patches_test"
    extract_and_save_subset(
        img_anno_paths=get_img_ano_paths(ds_folder=ds, sample="test"),
        out_folder=out_dir,
        patch_size=patch_size,
        layer=layer,
        patches_per_class=patches_per_class,
        device=device,
    )
    print(f"saved test patches under {out_dir}")
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--layer", type=int, default=2)
    parser.add_argument("--patch_size", type=int, default=224)
    parser.add_argument("--patches_per_class", type=int, default=100)
    args = parser.parse_args(argv)
    extract_patches_for_test_set(args.layer, args.patch_size, args.patches_per_class)


if __name__ == "__main__":
    main()
