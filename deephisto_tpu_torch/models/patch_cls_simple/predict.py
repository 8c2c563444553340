"""Single-patch prediction CLI, a port of
``deephisto_tpu/models/patch_cls_simple/predict.py``: load a best-model
checkpoint (the JAX package's flax msgpack format), classify one image file,
print the class, with the same /255 normalization as training.

Images are read with the port's PNG codec, and one that is not
``patch_size``² is resized as PIL's bilinear resize does it, byte for byte
(``slide.base._resize_uint8``); another format (JPEG) needs PIL to decode
and raises where it is not installed.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ..._imageio import read_png
from ...slide.base import _resize_uint8
from ...train.checkpoint import load_model as load_weights
from ...train.checkpoint import load_variables
from .model import get_model
from .utils import load_config

CONFIG_PATH = Path(__file__).with_name("config.yaml")


def load_image(image_path: Path | str, patch_size: int = 224) -> np.ndarray:
    """(patch_size, patch_size, 3) uint8 RGB of the image at ``image_path``."""
    image_path = Path(image_path)
    if image_path.suffix == ".png":
        img = read_png(image_path)
    else:
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"{image_path}: reading a non-PNG image needs PIL, which is not installed"
            ) from None
        img = np.asarray(Image.open(image_path).convert("RGB"), dtype=np.uint8)
    if img.shape[:2] != (patch_size, patch_size):
        img = _resize_uint8(img, (patch_size, patch_size))
    return img


@torch.no_grad()
def predict(image_path: Path | str, weights_path: Path | str, cfg: dict | None = None,
            device=None) -> int:
    """The class index of the image at ``image_path`` under the checkpoint
    ``weights_path`` and the model ``cfg`` describes (the packaged config by
    default), on ``device`` (the current CUDA device by default)."""
    cfg = cfg or load_config(CONFIG_PATH)
    device = resolve_device(device)
    context = cfg["model"].get("context", 0)
    model = get_model(
        cfg["model"]["n_classes"],
        depth=cfg["model"].get("depth", 18),
        stem=cfg["model"].get("stem", "imagenet"),
        arch=cfg["model"].get("arch", "resnet"),
        width=cfg["model"].get("width", 1),
        patch=cfg["model"].get("patch", 16),
        input_size=cfg["dataset"]["patch_size"] + 2 * context,
    )
    load_variables(model, load_weights(weights_path))
    model = model.to(device).eval()
    img = load_image(image_path, cfg["dataset"]["patch_size"])
    if context:
        # context-trained checkpoint (model.context): classify the patch the
        # way it was trained — edge-replicated surroundings, center feature
        # block (the trainer's disk-test convention)
        from .context import ContextWindowModel

        model = ContextWindowModel(model, patch_size=cfg["dataset"]["patch_size"],
                                   context=context).eval()
        img = np.pad(img, ((context, context), (context, context), (0, 0)), mode="edge")
    x = torch.from_numpy(img[None]).to(device).float() / 255.0  # match training
    return int(model(x).argmax(-1)[0])


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Classify one patch image with the trained model."
    )
    parser.add_argument("image", help="path to the patch image")
    parser.add_argument(
        "weights", nargs="?", default="./output/best_model.msgpack",
        help="checkpoint path (default ./output/best_model.msgpack)",
    )
    parser.add_argument(
        "--config", default=None,
        help="model config YAML (to load s2d-stem / ViT checkpoints)",
    )
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    cfg = load_config(args.config) if args.config else None
    cls = predict(args.image, args.weights, cfg)
    print(f"Predicted Class: {cls}")


if __name__ == "__main__":
    main()
