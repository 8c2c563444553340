"""Full-WSI sliding-window inference with stitched class maps, a port of
``deephisto_tpu/predict/full_patched.py`` (reference
examples/predict_full_patched.py:22-126).

:class:`ImagePredictorPatched` drives any sampler's (patches, progress)
batches through a host predictor callable (:func:`batch_predictor`) and
stitches the scores into a map on the device with kernel K2;
:func:`process_on_device` keeps a full-image sampler's batches on the device
(K1's float mode, the forward, K2). Inference never builds gradients; the
map accumulates raw logits unless ``softmax``; ``normalize_counts`` divides
by the patches covering each cell (the reference left it commented out).

:func:`perform_and_save_visualizations` writes the colorized mask, the
downscaled slide and their overlay as the JAX package's JPEG files
(``<stem>_mask.jpg``, ``<stem>.jpg``, ``<stem>_overlay.jpg``, Pillow at
quality 95).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..anno import AnnoDescription
from ..ops.stitch import scatter_add_map_exact
from ..slide import Patch, Slide, open_slide
from .fcn import check_uint8_classes
from .pipeline import model_device


class ImagePredictorPatched:
    """Stitch per-patch class scores into a downscaled whole-slide class map
    held on ``device`` (the current CUDA device by default)."""

    def __init__(
        self,
        psim_path: Path | str | Slide,
        patch_sampler,
        batch_predictor: Callable[[list[Patch]], np.ndarray] | None,
        anno: AnnoDescription,
        layer: int,
        downscale: int = 4,
        device=None,
    ):
        self.patch_sampler = patch_sampler
        self.batch_predictor = batch_predictor
        check_uint8_classes(len(anno.anno_classes))
        self.anno = anno
        self.layer = layer
        self.downscale = downscale
        self.device = resolve_device(device)
        if isinstance(psim_path, Slide):
            self.h, self.w = psim_path.layer_size(layer)
        else:
            with open_slide(psim_path) as slide:
                self.h, self.w = slide.layer_size(layer)

    def process(self, verbose: bool = True) -> np.ndarray:
        """Iterate the sampler, predict, scatter-add, argmax
        (reference predict_full_patched.py:40-63)."""
        from tqdm import tqdm

        d = self.downscale
        n = len(self.anno.anno_classes)
        prediction = torch.zeros((self.h // d, self.w // d, n), dtype=torch.float32,
                                 device=self.device)

        progress_bar = tqdm(total=100, desc="Predicting", unit="step", disable=not verbose)
        for patches, progress in self.patch_sampler:
            patch_preds = torch.as_tensor(np.asarray(self.batch_predictor(patches)))
            coords_raw = np.asarray([[p.pos_y, p.pos_x] for p in patches], dtype=np.int32)
            scatter_add_map_exact(prediction, torch.from_numpy(coords_raw),
                                  patch_preds.to(self.device), patches[0].patch_size, d)
            progress_bar.n = round(progress * 100, 2)
            progress_bar.refresh()
        progress_bar.close()
        return prediction.argmax(dim=2).to(torch.uint8).cpu().numpy()


def process_on_device(
    sampler,
    model,
    n_classes: int,
    downscale: int = 4,
    softmax: bool = False,
    normalize_counts: bool = False,
    verbose: bool = True,
) -> np.ndarray:
    """The device path: a full-image sampler's float32 /255 batches (K1's
    float mode on a device layer) → forward → K2 into the score map and
    the count map, on the sampler's device, where ``model`` must be; only
    the final argmax map leaves the device."""
    from tqdm import tqdm

    check_uint8_classes(n_classes)
    device = sampler.device
    if model_device(model) != device:
        raise ValueError(
            f"model is on {model_device(model)}, the sampler on {device}; move it with "
            "model.to(device)"
        )
    d, ps = downscale, sampler.patch_size
    pred_map = torch.zeros((sampler.h // d, sampler.w // d, n_classes), dtype=torch.float32,
                           device=device)
    count_map = torch.zeros((sampler.h // d, sampler.w // d, 1), dtype=torch.float32,
                            device=device)
    model.eval()
    bar = tqdm(total=100, desc="Predicting", unit="step", disable=not verbose)
    with torch.inference_mode():
        for patches, coords, progress in sampler.device_generator(torch.float32):
            logits = model(patches)
            if softmax:
                logits = torch.softmax(logits.float(), dim=-1)
            coords = torch.as_tensor(coords).to(device)
            scatter_add_map_exact(pred_map, coords, logits, ps, d)
            ones = torch.ones((coords.shape[0], 1), dtype=torch.float32, device=device)
            scatter_add_map_exact(count_map, coords, ones, ps, d)
            bar.n = round(progress * 100, 2)
            bar.refresh()
        bar.close()
        if normalize_counts:
            pred_map = pred_map / torch.clamp_min(count_map, 1.0)
        return pred_map.argmax(dim=2).to(torch.uint8).cpu().numpy()


def batch_predictor(patches: list[Patch], model) -> np.ndarray:
    """Reference-parity predictor callable (predict_full_patched.py:66-78):
    stack → /255 in float32 on the host → forward on the model's device →
    raw logits as a float32 numpy array. NHWC throughout."""
    features = np.stack([p.data for p in patches]).astype(np.float32) / 255.0
    model.eval()
    with torch.inference_mode():
        logits = model(torch.from_numpy(features).to(model_device(model)))
    return logits.float().cpu().numpy()


def perform_and_save_visualizations(
    img_path: Path | str | Slide,
    anno_dsc: AnnoDescription,
    pred: np.ndarray,
    out_dir: Path = Path("."),
) -> dict[str, Path]:
    """Colorized mask, downscaled original (Pillow's bilinear resize of the
    full-resolution slide, ``Slide.get_region``), and α=0.6 overlay, as
    JPEG at quality 95 (reference predict_full_patched.py:81-113). Needs
    Pillow."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(exist_ok=True, parents=True)

    h, w = pred.shape[:2]
    colored = np.zeros((h, w, 3), dtype=np.uint8)
    for anno in anno_dsc.anno_classes:
        colored[pred == anno.id] = anno.color

    if isinstance(img_path, Slide):
        slide, stem = img_path, "slide"
        img = slide.get_region((0, 0), (slide.height, slide.width), target_hw=(h, w))
    else:
        stem = Path(img_path).stem
        with open_slide(img_path) as slide:
            img = slide.get_region((0, 0), (slide.height, slide.width), target_hw=(h, w))

    paths = {
        "mask": out_dir / f"{stem}_mask.jpg",
        "original": out_dir / f"{stem}.jpg",
        "overlay": out_dir / f"{stem}_overlay.jpg",
    }
    Image.fromarray(colored).save(paths["mask"], quality=95)
    Image.fromarray(img).save(paths["original"], quality=95)
    alpha = 0.6
    overlay = (img * alpha + colored * (1 - alpha)).astype(np.uint8)
    Image.fromarray(overlay).save(paths["overlay"], quality=95)
    return paths


def load_model(
    weights_path: Path | str,
    n_classes: int = 5,
    depth: int = 18,
    stem: str = "imagenet",
    arch: str = "resnet",
    cfg: dict | None = None,
    device=None,
):
    """The best-model checkpoint (flax msgpack, written by either package)
    in the model it was trained as, on ``device`` in eval mode (reference
    predict_full_patched.py:116-126; the JAX function returns the module and
    its variables, the port one module holding them). Pass ``cfg`` (the
    training config dict) so checkpoints trained with the s2d stem or a ViT
    arch rebuild the matching module."""
    from ..models.patch_cls_simple.model import get_model
    from ..train.checkpoint import load_model as load_weights
    from ..train.checkpoint import load_variables

    width, patch = 1, 16
    if cfg is not None:
        m = cfg["model"]
        n_classes = m.get("n_classes", n_classes)
        depth = m.get("depth", depth)
        stem = m.get("stem", stem)
        arch = m.get("arch", arch)
        width = m.get("width", 1)
        patch = m.get("patch", 16)
    model = get_model(n_classes, depth=depth, stem=stem, arch=arch, width=width, patch=patch)
    load_variables(model, load_weights(weights_path))
    return model.to(resolve_device(device)).eval()
