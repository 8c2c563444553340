"""Long-lived serving engine over the predicts, a port of
``deephisto_tpu/serve/engine.py`` (``ServingEngine``, ``_PatchBatcher``,
``_load_calib``, ``MODES``, ``PRE_TILE_MAX_PIXELS``).

The checkpoint loads once and the model stays on the card across requests;
slides can be staged on the card for repeated fcn serving (LRU-evicted past
``max_staged_slides``); one lock serializes the card's work, so the threaded
HTTP server (``server.py``) may call the engine from any thread.

Modes:
  fcn    — the overlap-free dense map (ResNet family; ``predict_full_fcn``,
           or ``predict_full_fcn_streamed`` for a slide over
           ``stream_above_bytes``: the same map)
  dense  — the exact stride-112 sliding window (``predict_full_fused``)
  random — the coverage-guided random predict (``predict_full_random_fused``)

A ViT serves dense and random only (fcn needs the ResNet's stride-32
feature map). ``int8=True`` serves the int8 PTQ model (``quantize_model``):
for the ResNet one pack_l1 model for fcn (where the model supports it) and
one unpacked model for the other modes.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..profiling import span

MODES = ("fcn", "dense", "random")

# Staging cut-off: slides up to this many pixels are staged as the
# pre-tiled grid (``stage_for_fcn(pre_tile=True)``), larger ones untiled;
# the two give the same map. The JAX package's value, kept; the card's own
# cut-off is not measured yet.
PRE_TILE_MAX_PIXELS = 25_000 ** 2


class _PatchBatcher:
    """Coalesce concurrent single-patch requests into one LANES-wide forward.

    A daemon thread drains a queue: the first request opens a window of
    ``wait_ms`` (the latency cost for a lone request), and followers that
    arrive inside it ride the same zero-padded batch. The models run in
    eval mode, so the batch's other lanes cannot change a row's result. A
    failing batch raises in each of its requests; the thread lives on.
    ``device``: the CUDA device the thread sets as its own, or None."""

    def __init__(self, run_batch, lanes: int, wait_ms: float, device=None):
        self._run = run_batch  # list[(P, P, 3) u8] -> (n, nc) float np
        self._lanes = int(lanes)
        self._wait_s = float(wait_ms) / 1e3
        self._device = device
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                         name="deephisto-patch-batcher")
        self._thread.start()

    def submit(self, img: np.ndarray) -> np.ndarray:
        done = threading.Event()
        box: list[Any] = [None]
        self._q.put((img, box, done))
        done.wait()
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def close(self) -> None:
        """Stop the thread (after the requests queued before this call)."""
        self._q.put(None)
        self._thread.join()

    def _loop(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self._wait_s
            stop = False
            while len(batch) < self._lanes:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            try:
                probs = self._run([b[0] for b in batch])
                for (_, box, done), row in zip(batch, probs):
                    box[0] = row
                    done.set()
            except BaseException as e:  # noqa: BLE001 — the daemon must survive
                for _, box, done in batch:
                    box[0] = e
                    done.set()
            if stop:
                return


def _load_calib(calib, patch: int = 224) -> list:
    """Calibration batches for int8 PTQ from an (N, P, P, 3) uint8 (or
    float in [0, 1]) array, a ``.npy`` path, or None: uniform noise of 64
    images of ``patch``² (the JAX package's 224 for a ResNet; a ViT's token
    count fixes its input size), enough to measure speed; a model served for
    its answers should be calibrated on real patches. Returns float32 numpy
    batches of up to 64 images in [0, 1]."""
    if calib is None:
        rng = np.random.default_rng(0)
        return [rng.random((64, patch, patch, 3), dtype=np.float32)]
    if isinstance(calib, (str, Path)):
        calib = np.load(calib)
    arr = np.asarray(calib)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return [np.asarray(arr[i : i + 64], np.float32) for i in range(0, len(arr), 64)]


class ServingEngine:
    """Checkpoint-resident predict service.

    Build it with :meth:`from_checkpoint` (the trainer's config YAML and
    msgpack weights) or from a model and its config dict. ``device``: None
    serves on the current CUDA device and raises without one; ``"cpu"``
    runs the plain versions of the kernels. The model is moved there and put
    in eval mode. The card's work is serialized behind one lock, so the
    engine is safe to call from the threaded HTTP server."""

    def __init__(
        self,
        model,
        cfg: dict,
        *,
        int8: bool = False,
        calib=None,
        mode: str = "fcn",
        tile: int = 1024,
        halo: int = 32,
        tile_batch: int = 16,
        max_staged_slides: int = 4,
        stream_above_bytes: int = 8 << 30,
        patch_lanes: int = 8,
        patch_wait_ms: float = 2.0,
        device=None,
    ):
        from ..models import quantize_model
        from ..models.quantize import quantize_resnet, supports_pack_l1
        from ..models.vit import ViT

        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.is_vit = isinstance(model, ViT)
        self.n_classes = int(cfg["model"]["n_classes"])
        self.patch_size = int(cfg["dataset"]["patch_size"])
        self.context = int(cfg["model"].get("context", 0))
        self.int8 = bool(int8)
        if mode == "fcn" and self.is_vit:  # fcn needs the stride-32 conv feature map
            mode = "dense"
        self.default_mode = mode
        self.tile, self.halo, self.tile_batch = int(tile), int(halo), int(tile_batch)
        # fcn requests for slides beyond this many bytes stream to the card in
        # stripes (predict_full_fcn_streamed, the same map). The JAX
        # package's default, kept; the card's own cut-off is not measured yet.
        self.stream_above_bytes = int(stream_above_bytes)
        self._lock = threading.Lock()
        self._staged: OrderedDict[str, Any] = OrderedDict()
        self._max_staged = int(max_staged_slides)
        self._requests = 0
        # the LANES-wide patch forward and its request coalescer, made at the
        # first /v1/patch request (_build_patch_program)
        self.patch_lanes = max(1, int(patch_lanes))
        self.patch_wait_ms = float(patch_wait_ms)
        self._patch_fn = None
        self._patch_batcher = None

        self.qmodel = self.qmodel_fcn = None
        if int8:
            batches = _load_calib(calib, self.patch_size if self.is_vit else 224)
            if self.is_vit:
                self.qmodel = quantize_model(self.model, batches)
            else:
                # one pack_l1 model for fcn where the model supports it (the
                # BasicBlock ResNets; bottleneck ones serve fcn unpacked), one
                # unpacked model for the exact and random modes
                self.qmodel_fcn = quantize_resnet(self.model, batches,
                                                  pack_l1=supports_pack_l1(self.model))
                self.qmodel = quantize_resnet(self.model, batches)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, config_path, weights_path, **kw) -> "ServingEngine":
        """The engine over a trainer's artifacts: its config YAML and either
        its weights-only flax msgpack checkpoint (``best_model.msgpack``,
        from either package) or a train-state checkpoint directory of
        ``train/dist_ckpt.py`` (mesh-scale training; its latest step is
        served, weights only)."""
        from ..models.patch_cls_simple.model import get_model
        from ..models.patch_cls_simple.utils import load_config
        from ..train import checkpoint, dist_ckpt

        cfg = load_config(config_path)
        m = cfg["model"]
        model = get_model(
            m["n_classes"],
            depth=m.get("depth", 18),
            stem=m.get("stem", "imagenet"),
            arch=m.get("arch", "resnet"),
            width=m.get("width", 1),
            patch=m.get("patch", 16),
            input_size=cfg["dataset"]["patch_size"] + 2 * int(m.get("context", 0)),
        )
        read = dist_ckpt.load_model if Path(weights_path).is_dir() else checkpoint.load_model
        checkpoint.load_variables(model, read(weights_path))
        return cls(model, cfg, **kw)

    # ------------------------------------------------------------------
    def _model_for(self, mode: str):
        """The model serving ``mode``: int8 when loaded so."""
        if not self.int8:
            return self.model
        if mode == "fcn" and self.qmodel_fcn is not None:
            return self.qmodel_fcn
        return self.qmodel

    def info(self) -> dict:
        m = self.cfg["model"]
        return {
            "arch": m.get("arch", "resnet"),
            "depth": m.get("depth", 18),
            "stem": m.get("stem", "imagenet"),
            "width": m.get("width", 1),
            "context": self.context,
            "n_classes": self.n_classes,
            "patch_size": self.patch_size,
            "int8": self.int8,
            "default_mode": self.default_mode,
            "modes": list(MODES) if not self.is_vit else ["dense", "random"],
            "fcn": {"tile": self.tile, "halo": self.halo, "tile_batch": self.tile_batch},
            "staged_slides": list(self._staged),
            "requests": self._requests,
            "patch_lanes": self.patch_lanes,
        }

    # ------------------------------------------------------------------
    def predict_patch(self, img_u8: np.ndarray) -> dict:
        """Classify one (H, W, 3) uint8 patch, as the reference predict.py:
        /255 as in training, resized to the patch size with Pillow's
        bilinear filter (``slide.base._resize_uint8``, the same bytes), and
        through the training-time context window (edge-padded) for a
        context-trained checkpoint. The float model answers, also in an
        int8 engine, as in the JAX package."""
        from ..slide.base import _resize_uint8

        img = np.asarray(img_u8)
        if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
            raise ValueError(f"expected (H, W, 3) uint8 patch, got {img.shape} {img.dtype}")
        ps = self.patch_size
        if img.shape[:2] != (ps, ps):
            img = _resize_uint8(img, (ps, ps))
        if self.context:
            c = self.context
            img = np.pad(img, ((c, c), (c, c), (0, 0)), mode="edge")
        with self._lock:
            self._requests += 1
            if self._patch_fn is None:
                self._build_patch_program(ps)
        probs = self._patch_batcher.submit(img)
        return {"class": int(np.argmax(probs)), "probs": [float(p) for p in probs]}

    def _build_patch_program(self, ps: int):
        """The LANES-wide patch forward (u8 → /255 → model → softmax in f32)
        and the request coalescer feeding it. Called under the engine lock."""
        model = self.model
        if self.context:
            from ..models.patch_cls_simple.context import ContextWindowModel

            model = ContextWindowModel(self.model, patch_size=ps, context=self.context)
        lanes, side, dev = self.patch_lanes, ps + 2 * self.context, self.device

        @torch.inference_mode()
        def patch_fn(x_u8: torch.Tensor) -> torch.Tensor:  # (lanes, side, side, 3) uint8
            logits = model(x_u8.float() / 255.0)
            return torch.softmax(logits.float(), dim=-1)

        def run_batch(imgs: list) -> np.ndarray:
            arr = np.zeros((lanes, side, side, 3), np.uint8)
            for i, im in enumerate(imgs):
                arr[i] = im
            with self._lock:  # the card's work serializes with slide predicts
                probs = patch_fn(torch.from_numpy(arr).to(dev)).cpu().numpy()
            return probs[: len(imgs)]

        self._patch_fn = patch_fn
        self._patch_batcher = _PatchBatcher(run_batch, lanes, self.patch_wait_ms, dev)

    def close(self) -> None:
        """Stop the patch batcher's thread, if one was started."""
        batcher, self._patch_batcher, self._patch_fn = self._patch_batcher, None, None
        if batcher is not None:
            batcher.close()

    # ------------------------------------------------------------------
    def stage_slide(self, key: str, image: np.ndarray) -> dict:
        """Stage a slide on the card for repeated fcn serving (the s2d pack
        paid once, ``stage_for_fcn``); LRU-evicts past ``max_staged_slides``.
        Slides up to ``PRE_TILE_MAX_PIXELS`` are staged as the pre-tiled
        grid, larger ones untiled (the same map)."""
        from ..predict.fcn import stage_for_fcn

        if self.is_vit:
            raise ValueError("staging is the fcn mode's path; a ViT has none")
        fcn_model = self._model_for("fcn")
        if getattr(fcn_model, "stem", None) != "s2d":
            raise ValueError(
                "staging requires an s2d-stem ResNet (FcnStagedSlide is the "
                "s2d-packed representation; predict the slide directly instead)"
            )
        # a pack_l1 int8 model takes the pack=8 ("s2d8") staging
        pack = 8 if getattr(fcn_model, "pack_l1", False) else 4
        image = np.asarray(image)
        with self._serving():
            self._requests += 1
            pre_tile = image.shape[0] * image.shape[1] <= PRE_TILE_MAX_PIXELS
            staged = stage_for_fcn(image, tile=self.tile, halo=self.halo, pack=pack,
                                   pre_tile=pre_tile, device=self.device)
            self._staged[key] = staged
            self._staged.move_to_end(key)
            while len(self._staged) > self._max_staged:
                self._staged.popitem(last=False)
        return {"key": key, "h": staged.h, "w": staged.w, "staged": list(self._staged)}

    @contextlib.contextmanager
    def _serving(self):
        """Hold the engine's lock: the wait for it (``engine.lock_wait``) and
        the hold (``engine.serve``), each a span."""
        with span("engine.lock_wait"):
            self._lock.acquire()
        try:
            with span("engine.serve"):
                yield
        finally:
            self._lock.release()

    def evict_slide(self, key: str) -> bool:
        with self._lock:
            return self._staged.pop(key, None) is not None

    # ------------------------------------------------------------------
    def predict_slide(
        self,
        image: np.ndarray | None = None,
        *,
        key: str | None = None,
        mode: str | None = None,
        seed: int = 0,
    ) -> tuple[np.ndarray, dict]:
        """Full-WSI class map. ``image``: an (H, W, 3) uint8 slide, or
        ``key``: a staged slide (fcn mode only). Returns the (H/16, W/16)
        uint8 argmax map and its meta."""
        from ..predict.fcn import predict_full_fcn
        from ..predict.pipeline import predict_full_fused, predict_full_random_fused
        from ..predict.streaming import predict_full_fcn_streamed

        with span("engine.request") as request:
            mode = mode or self.default_mode
            if mode not in MODES:
                raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
            if self.is_vit and mode == "fcn":
                raise ValueError("fcn mode needs a ResNet-family backbone")
            if (image is None) == (key is None):
                raise ValueError("pass exactly one of image= or key=")
            if key is not None:
                if mode != "fcn":
                    raise ValueError("staged slides serve the fcn mode only")
                with self._serving():
                    staged = self._staged.get(key)
                    if staged is not None:
                        self._staged.move_to_end(key)
                if staged is None:
                    raise KeyError(f"no staged slide {key!r}")
                src: Any = staged
                h, w = staged.h, staged.w
            else:
                src = np.asarray(image)
                if src.ndim != 3 or src.shape[-1] != 3 or src.dtype != np.uint8:
                    raise ValueError(f"expected (H, W, 3) uint8 slide, got {src.shape} {src.dtype}")
                h, w = src.shape[:2]

            request.update(mode=mode, h=h, w=w)
            model = self._model_for(mode)
            dev, ps, nc = self.device, self.patch_size, self.n_classes
            fcn = dict(patch_size=ps, tile=self.tile, halo=self.halo, tile_batch=self.tile_batch,
                       device=dev)
            streamed = False
            with self._serving():
                self._requests += 1
                if mode == "fcn":
                    if key is None and src.nbytes > self.stream_above_bytes:
                        streamed = True  # stripes through the card, the same map
                        amap, _ = predict_full_fcn_streamed(src, model, nc, **fcn)
                    else:
                        amap, _ = predict_full_fcn(src, model, nc, **fcn)
                elif mode == "dense":
                    amap, _ = predict_full_fused(src, model, nc, patch_size=ps, device=dev)
                else:
                    # Gumbel top-k draws from the speedup-16 coverage grid: a batch
                    # larger than the grid cannot be drawn (small slides)
                    batch = min(512, (h // 16) * (w // 16))
                    amap = predict_full_random_fused(src, model, nc, patch_size=ps,
                                                     batch_size=max(batch, 1), seed=seed,
                                                     device=dev)[0]
            amap = np.asarray(amap, np.uint8)
            meta = {"mode": mode, "h": h, "w": w, "downscale": 16, "int8": self.int8,
                    "streamed": streamed, "map_shape": list(amap.shape)}
            return amap, meta

    # ------------------------------------------------------------------
    def warmup(self, h: int, w: int, mode: str | None = None) -> dict:
        """Run a slide of (h, w) through ``mode`` and one patch before
        traffic, so the first requests pay no kernel build, cuDNN algorithm
        pick or allocator growth."""
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        _, meta = self.predict_slide(img, mode=mode)
        self.predict_patch(
            rng.integers(0, 255, (self.patch_size, self.patch_size, 3), dtype=np.uint8)
        )
        meta["warmup"] = True
        return meta
