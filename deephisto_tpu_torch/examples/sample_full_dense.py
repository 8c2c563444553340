"""Example of using FullImageDenseSampler (mirror of reference
examples/sample_full_dense.py; flags default to its hardcoded values)."""

import argparse

from ..samplers import FullImageDenseSampler, SamplerExecutionMode
from ..utils import get_img_ano_paths
from ._dataset import example_dataset


def sample_full_dense(layer: int = 2, patch_size: int = 224, batch_size: int = 16,
                      stride: int = 112, device=None) -> int:
    """Tile the first test slide densely; print each batch's shapes and
    progress. Returns the number of batches."""
    img_path = get_img_ano_paths(example_dataset(), sample="test")[0][0]
    patch_sampler = FullImageDenseSampler(
        img_path,
        layer=layer,
        patch_size=patch_size,
        batch_size=batch_size,
        stride=stride,
        mode=SamplerExecutionMode.INMEMORY_SINGLEPROC,
        device=device,
    )
    n = 0
    for inputs, coords, filled_ratio in patch_sampler.generator_torch():
        print(tuple(inputs.shape), tuple(coords.shape), filled_ratio)
        n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--layer", type=int, default=2)
    parser.add_argument("--patch_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--stride", type=int, default=112)
    args = parser.parse_args(argv)
    sample_full_dense(args.layer, args.patch_size, args.batch_size, args.stride)


if __name__ == "__main__":
    main()
