"""Make a full prediction on a WSI image using a saved model (the port of
``examples/predict_full_patched.py``, mirror of reference
examples/predict_full_patched.py:129-183: the same canonical class colours,
flags and outputs). Falls back to an untrained model with a warning when no
checkpoint exists, so the pipeline runs end to end.

Modes: the coverage-guided random predict (default), ``--dense`` (the exact
stride-112 predict), ``--host_loop`` (a full-image sampler's patches
through a host predictor, random or with ``--dense`` dense), ``--int8``
(post-training int8 quantization, calibrated on patches of the slide
itself, then the random or dense predict) and ``--fcn`` (the
fully-convolutional mode; with ``--int8`` on the int8 model). The mask, the
slide preview and the overlay are written as JPEG under ``./output/``, by
Pillow, as the JAX package writes them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .._device import resolve_device
from ..anno import AnnoDescription
from ..models import quantize_model
from ..models.patch_cls_simple.model import get_model, init_model
from ..predict import (
    ImagePredictorPatched,
    batch_predictor,
    load_model,
    perform_and_save_visualizations,
    predict_full_fcn,
    predict_full_fused,
    predict_full_random_fused,
)
from ..samplers import FullImageDenseSampler, FullImageRndSampler, SamplerExecutionMode
from ..slide import open_slide
from ..utils import get_img_ano_paths
from ._dataset import example_dataset

# the canonical 5-class colours (reference :140-149)
CLASS_COLORS = {
    "AT": (245, 119, 34),  # AT (orange)
    "BG": (153, 255, 255),  # BG (cyan)
    "LP": (64, 170, 72),  # LP (green)
    "MM": (255, 0, 0),  # MM (red)
    "TUM": (33, 67, 156),  # TUM (blue)
}
LAYER, DOWNSCALE_VIS, PATCH_SIZE, BATCH_SIZE = 2, 16, 224, 64
CALIB_BATCHES, CALIB_SIZE = 2, 32


def calibration_batches(image: np.ndarray, seed: int = 0) -> list[np.ndarray]:
    """2 batches of 32 patches of ``image`` at seeded random corners, f32
    /255, as the JAX CLI calibrates ``--int8`` (:113-132)."""
    h, w = image.shape[:2]
    rng = np.random.default_rng(seed)
    calib = []
    for _ in range(CALIB_BATCHES):
        ys = rng.integers(0, h - PATCH_SIZE, size=CALIB_SIZE)
        xs = rng.integers(0, w - PATCH_SIZE, size=CALIB_SIZE)
        calib.append(
            np.stack([image[y : y + PATCH_SIZE, x : x + PATCH_SIZE] for y, x in zip(ys, xs)])
            .astype(np.float32) / 255.0
        )
    return calib


def predict_full_patched(
    weights: Path = Path("./output/best_model.msgpack"),
    dense: bool = False,
    host_loop: bool = False,
    int8: bool = False,
    fcn: bool = False,
    out_dir: Path = Path("./output/"),
    device=None,
) -> dict:
    """The CLI's body: predict the dataset's first test slide at layer 2 in
    the mode the flags choose and write the visualizations to ``out_dir``.
    Returns {"pred": the uint8 class map, "paths": the JPEGs, "model": the
    model that predicted; on the device paths "scores", the score map; and
    for the random predict "coverage", "filled" and "steps"}."""
    if int8 and host_loop:
        raise ValueError("--int8 applies to the fused device paths, not --host_loop")
    if fcn and host_loop:
        raise ValueError("--fcn is a fused device path, not --host_loop")
    device = resolve_device(device)
    img_path = get_img_ano_paths(example_dataset(), sample="test")[0][0]
    anno_dsc = AnnoDescription.with_known_colors(CLASS_COLORS)
    n_classes = len(CLASS_COLORS)
    out = {}

    # --- load model ---
    weights = Path(weights)
    if weights.exists():
        model = load_model(weights, n_classes=n_classes, device=device)
    else:
        print(f"warning: {weights} not found; using an untrained model")
        model = init_model(get_model(n_classes), seed=0).to(device).eval()

    # --- make WSI prediction ---
    if host_loop:
        # reference-style incremental path: sampler generator + host predictor
        if dense:
            patch_sampler = FullImageDenseSampler(
                img_path, layer=LAYER, patch_size=PATCH_SIZE, batch_size=BATCH_SIZE,
                stride=112, device=device,
            )
        else:
            patch_sampler = FullImageRndSampler(
                img_path, layer=LAYER, patch_size=PATCH_SIZE, batch_size=BATCH_SIZE,
                mode=SamplerExecutionMode.INMEMORY_SINGLEPROC, device=device,
            )
        predictor = ImagePredictorPatched(
            img_path,
            patch_sampler=patch_sampler.generator(),
            batch_predictor=lambda patches: batch_predictor(patches, model),
            anno=anno_dsc,
            layer=LAYER,
            downscale=DOWNSCALE_VIS,
            device=device,
        )
        pred = predictor.process()
    else:
        # the device paths (the fast default)
        with open_slide(img_path) as slide:
            h, w = slide.layer_size(LAYER)
            image = slide.get_region_from_layer(LAYER, (0, 0), (h, w))
        if int8:
            # serving mode: calibrate activation scales on patches sampled
            # from this slide, then swap in the int8 model (quantize.py)
            model = quantize_model(model, calibration_batches(image))
            print("quantized to int8 (per-channel weights, calibrated activations)")
        if fcn:
            pred, out["scores"] = predict_full_fcn(
                image, model, n_classes=n_classes, patch_size=PATCH_SIZE,
                downscale=DOWNSCALE_VIS, device=device,
            )
        elif dense:
            pred, out["scores"] = predict_full_fused(
                image, model, n_classes=n_classes, patch_size=PATCH_SIZE, stride=112,
                batch_size=BATCH_SIZE, downscale=DOWNSCALE_VIS, device=device,
            )
        else:
            pred, out["scores"], out["coverage"], filled, steps = predict_full_random_fused(
                image, model, n_classes=n_classes, patch_size=PATCH_SIZE,
                batch_size=BATCH_SIZE, downscale=DOWNSCALE_VIS, speedup=16, device=device,
            )
            print(f"coverage {filled:.3f} after {steps} batches")
            out.update(filled=filled, steps=steps)

    # --- save visualizations ---
    out["paths"] = perform_and_save_visualizations(img_path, anno_dsc, pred, out_dir=out_dir)
    print(f"saved mask / original / overlay under {out_dir}")
    out.update(pred=pred, model=model)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=Path, default=Path("./output/best_model.msgpack"))
    parser.add_argument("--dense", action="store_true", help="dense sampler instead of random")
    parser.add_argument(
        "--host_loop",
        action="store_true",
        help="use the reference-style host loop (generic sampler + batch_predictor)",
    )
    parser.add_argument(
        "--int8",
        action="store_true",
        help="post-training-quantize the model to int8 before predicting "
        "(calibrates on patches from the slide itself; fused paths only)",
    )
    parser.add_argument(
        "--fcn",
        action="store_true",
        help="overlap-free fully-convolutional dense mode: backbone runs once "
        "per pixel instead of 4x (stride-112 windows); non-exact vs the patch "
        "path (deephisto_tpu_torch/predict/fcn.py docstring)",
    )
    args = parser.parse_args(argv)
    if args.int8 and args.host_loop:
        parser.error("--int8 applies to the fused device paths, not --host_loop")
    if args.fcn and args.host_loop:
        parser.error("--fcn is a fused device path, not --host_loop")
    predict_full_patched(args.weights, args.dense, args.host_loop, args.int8, args.fcn)


if __name__ == "__main__":
    main()
