"""Example of using AnnoRegionDenseSampler (mirror of reference
examples/sample_annotated_dense.py: total patches + items/s + per-class
counts). ``--jax`` (the JAX CLI's flag name) runs the batched device pass
instead of per-patch structs."""

import argparse
import time

import numpy as np

from ..samplers import AnnoRegionDenseSampler
from ..utils import get_img_ano_paths
from ._dataset import example_dataset


def sample_annotated_dense(device_pass: bool = False, device=None) -> np.ndarray:
    """Every qualifying patch of the test slides' regions (224 px, stride
    112, layer 1), as structs or device batches of 64; returns the count of
    patches a class."""
    img_anno_paths = get_img_ano_paths(example_dataset(), sample="test")
    dataset = AnnoRegionDenseSampler(
        img_anno_paths, patch_size=224, stride=112, layer=1, device=device,
    )

    t0 = time.time()
    count = np.zeros([len(dataset.classes)], dtype=np.int32)
    if device_pass:
        print("Generating device-resident batches")
        for feats, labels, coords in dataset.device_generator(batch_size=64):
            for cl in labels.cpu().numpy().tolist():
                count[int(cl)] += 1
    else:
        print("Generating batches of structs")
        for patch, cls in dataset.structs_generator():
            count[cls] += 1
    t1 = time.time()

    print(f"Total patches: {np.sum(count)}")
    print(f"{np.sum(count) / (t1 - t0)} items/s")
    print(f"patches extracted for classes: {count}")
    return count


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--jax", action="store_true", help="batched device pass")
    args = parser.parse_args(argv)
    sample_annotated_dense(args.jax)


if __name__ == "__main__":
    main()
