"""Example of using AnnoRegionRndSampler — the throughput harness.

Mirror of reference examples/sample_annotated_rnd.py (same params: 40 batches
× 64 patches of 224², layer 1, patches_from_one_region=4,
one_image_for_batch=True; same items/s + per-class-count prints). ``--torch``
yields torch tensors on the CPU; the default yields Patch structs; ``--jax``
(the JAX CLI's flag name) uses the device-resident fast path.
"""

import argparse
import time

import numpy as np

from ..samplers import AnnoRegionRndSampler
from ..utils import get_img_ano_paths
from ._dataset import example_dataset


def sample_annotated_rnd(torch_out: bool = False, device_pass: bool = False,
                         n_batches: int = 40, device=None) -> np.ndarray:
    """``n_batches`` batches of 64 patches from the train slides; returns the
    count of patches a class."""
    img_anno_paths = get_img_ano_paths(example_dataset(), sample="train")
    n = n_batches
    b_size = 64  # number of patches per batch
    b_per_worker = 2  # accepted for parity; no worker processes exist

    dataset = AnnoRegionRndSampler(
        img_anno_paths,
        patch_size=224,
        layer=1,
        patches_from_one_region=4,
        one_image_for_batch=True,
        device=device,
    )

    t0 = time.time()
    count = np.zeros([len(dataset.classes)], dtype=np.int32)
    if device_pass:
        print("Generating device-resident batches")
        for f, cls, coords in dataset.device_generator(b_size, n):
            for cl in cls.cpu().numpy().tolist():
                count[int(cl)] += 1
    elif torch_out:
        print("Generating batches with torch tensors")
        g = dataset.torch_generator(batch_size=b_size, n_batches=n, batches_per_worker=b_per_worker)
        for f, cls, coords in g:
            print(f"inputs: {tuple(f.shape)}, cls: {tuple(cls.shape)}, crds: {tuple(coords.shape)}",
                  flush=True)
            for cl in cls.numpy().tolist():
                count[int(cl)] += 1
    else:
        print("Generating batches of structs")
        g = dataset.structs_generator(batch_size=b_size, n_batches=n,
                                      batches_per_worker=b_per_worker)
        for batch in g:
            print(f"batch of {len(batch)} patches with coords", flush=True)
            for patch, cls in batch:
                count[cls] += 1
    t1 = time.time()

    print(f"{n * b_size / (t1 - t0)} items/s")
    print(f"patches extracted for classes: {count}")
    return count


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--torch", action="store_true", help="if set, it will use torch tensor outputs"
    )
    parser.add_argument(
        "--jax", action="store_true", help="device-resident batches (fastest path)"
    )
    parser.add_argument(
        "--n_batches", type=int, default=40,
        help="batches to extract (reference hardcodes 40)",
    )
    args = parser.parse_args(argv)
    sample_annotated_rnd(args.torch, args.jax, args.n_batches)


if __name__ == "__main__":
    main()
