"""Example of using FullImageRndSampler (mirror of reference
examples/sample_full_random.py; flags default to its hardcoded values)."""

import argparse

from ..samplers import FullImageRndSampler, SamplerExecutionMode
from ..utils import get_img_ano_paths
from ._dataset import example_dataset


def sample_full_random(layer: int = 2, patch_size: int = 224, batch_size: int = 16,
                       device=None) -> float:
    """Tile the first test slide by coverage-guided random batches until it
    is covered; print each batch's shapes and filled ratio. Returns the last
    filled ratio."""
    img_path = get_img_ano_paths(example_dataset(), sample="test")[0][0]
    patch_sampler = FullImageRndSampler(
        img_path,
        layer=layer,
        patch_size=patch_size,
        batch_size=batch_size,
        mode=SamplerExecutionMode.INMEMORY_SINGLEPROC,
        device=device,
    )
    filled_ratio = 0.0
    for inputs, coords, filled_ratio in patch_sampler.generator_torch():
        print(tuple(inputs.shape), tuple(coords.shape), filled_ratio)
    return filled_ratio


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--layer", type=int, default=2)
    parser.add_argument("--patch_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=16)
    args = parser.parse_args(argv)
    sample_full_random(args.layer, args.patch_size, args.batch_size)


if __name__ == "__main__":
    main()
