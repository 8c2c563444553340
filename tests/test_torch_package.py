"""Structure of the port: it imports nothing of JAX or the JAX package, its
entry points run on the card unless asked for the CPU, and a kernel that
cannot be built raises."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deephisto_tpu_torch import _build
from deephisto_tpu_torch._device import resolve_device
from deephisto_tpu_torch.models.patch_cls_simple import get_model
from deephisto_tpu_torch.predict import predict_full_fused

ROOT = Path(__file__).resolve().parents[1]
# the training slice's modules, which the walk must reach (and import)
TRAINING_MODULES = {
    f"deephisto_tpu_torch.{m}" for m in (
        "anno.parse", "data.synthetic_dataset", "geometry.device", "geometry.polygon",
        "geometry.raster", "models.patch_cls_simple.train", "samplers.bank",
        "samplers.region", "samplers.weights", "slide.array_slide", "slide.base", "slide.dhs",
        "slide.synthetic", "train.metrics", "train.state", "utils",
    )
}


# the int8 slice's modules: PTQ, kernel K6's wrapper and the fcn predict
INT8_MODULES = {
    f"deephisto_tpu_torch.{m}" for m in ("models.quantize", "ops.conv_int8", "predict.fcn")
}

# the training program's modules: checkpoints, codecs, the CLI and its helpers
CLI_MODULES = {
    f"deephisto_tpu_torch.{m}" for m in (
        "_imageio", "ops.augment", "samplers.multimag", "train._msgpack", "train.checkpoint",
        "models.patch_cls_simple.context", "models.patch_cls_simple.predict",
        "models.patch_cls_simple.utils",
    )
}


# the predict CLI's slice: the full-image samplers, the sampling primitives,
# the predictors, the visualizations, the .psi adapter and the example CLIs
PREDICT_CLI_MODULES = {
    f"deephisto_tpu_torch.{m}" for m in (
        "anno.classes", "anno.palette", "anno.visualize", "ops.sampling", "predict.full_patched",
        "samplers.full", "slide.psi", "examples._dataset", "examples.predict_full_patched",
        "examples.sample_full_dense", "examples.sample_full_random",
        "examples.sample_annotated_dense", "examples.sample_annotated_rnd",
        "examples.extract_patches_for_test_set",
    )
}


# the serving slice's modules: the daemon, the streamed predicts and the
# ViT's int8 form
SERVE_MODULES = {
    f"deephisto_tpu_torch.{m}" for m in (
        "serve", "serve.engine", "serve.server", "serve.__main__", "predict.streaming",
        "models.quantize_vit",
    )
}


ALL_MODULES = TRAINING_MODULES | INT8_MODULES | CLI_MODULES | PREDICT_CLI_MODULES | SERVE_MODULES


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Nor the host libraries the card's machine lacks: msgpack, yaml and
    torchvision never, PIL and matplotlib only inside the functions that
    need them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deephisto_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"missing = set({sorted(ALL_MODULES)})"
        " - set(names)\n"
        "assert len(names) >= 50 and not missing, (names, missing)\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'deephisto_tpu', 'msgpack', 'yaml', "
        "'torchvision', 'PIL', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = get_model(5, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_full_fused(np.zeros((224, 224, 3), np.uint8), model, 5)


def test_model_on_another_device_is_refused():
    model = get_model(5, dtype=torch.float32).to("meta")
    with pytest.raises(ValueError, match="model.to"):
        predict_full_fused(np.zeros((224, 224, 3), np.uint8), model, 5, device="cpu")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 3\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="gather.cu \\(exit 3\\)"):
        _build.build()
    assert not list((tmp_path / "build").iterdir())  # nothing half-written is left


def test_library_names_follow_their_sources():
    assert "attention_bwd" in _build.SOURCES and "conv_int8" in _build.SOURCES
    names = {_build.library_path(n).name for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert _build.library_path("gather").parent == ROOT / "build" / "deephisto_tpu_torch"


def test_launch_counts_reset():
    _build.count_launch("k")
    _build.count_launch("k")
    assert _build.launches["k"] == 2
    _build.reset_launches()
    assert _build.launches["k"] == 0
