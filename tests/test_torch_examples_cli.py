"""The port's example CLIs (``deephisto_tpu_torch/examples``) on the CPU.

Each CLI body runs with ``device="cpu"`` on a small synthetic dataset (one
train and one test slide of 1024²). A checkpoint written by the JAX
package's ``save_model`` (a full-width ResNet-18, 5 classes, random
weights) is served by the port's predict CLI body with ``--dense``; its map
must equal the JAX CLI's on every cell, run in-process on the same slide
with its scan compiled without excess precision (tests/test_torch_pipeline.py),
and its score map must be within 1 % of the largest |score| of the JAX
CLI's. Both models run in bf16, whose convolutions XLA-CPU and oneDNN round
at different points: the scores differ by at most 0.18 % of the largest on
this slide, and every cell's top-2 margin is over 8 % of it. The random
trunk makes one class win every cell, so the score map, whose per-cell sums
count the patches over each cell, is what holds the layer, stride and
stitch to the JAX CLI's.

The single-patch CLI classifies a 300×200 PNG as the JAX package's does:
the port resizes it to the model's input with its PIL-exact bilinear resize.
"""

import runpy
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_pipeline import strict_jax_predict  # noqa: F401 (a fixture)
from test_torch_resnet import _random_variables

from deephisto_tpu.models.patch_cls_simple import predict as jax_predict
from deephisto_tpu.models.patch_cls_simple.model import get_model as jax_get_model
from deephisto_tpu.train import checkpoint as jck
from deephisto_tpu_torch.data import ensure_synthetic_dataset
from deephisto_tpu_torch.examples import (
    extract_patches_for_test_set,
    predict_full_patched,
    sample_annotated_dense,
    sample_annotated_rnd,
    sample_full_dense,
    sample_full_random,
)
from deephisto_tpu_torch.models.patch_cls_simple import predict as port_predict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six workers on the host's cores, and
    the many small ops of these predicts slow down by an order of magnitude
    when each worker's pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "ds"
    ensure_synthetic_dataset(root, n_train=1, n_test=1, height=1024, width=1024, seed=13,
                             max_layer=4)
    (root / ".synthetic_complete.json").unlink()  # served as it is, not rebuilt
    return root


@pytest.fixture
def in_dataset(dataset, monkeypatch):
    monkeypatch.setenv("DEEPHISTO_DATASET", str(dataset))
    return dataset


def test_sample_cli_bodies_run_on_the_cpu(in_dataset, capsys):
    assert sample_full_dense.sample_full_dense(batch_size=8, device="cpu") == 2  # 16 tiles of 512²
    assert sample_full_random.sample_full_random(device="cpu") == 1.0
    counts = sample_annotated_dense.sample_annotated_dense(device="cpu")
    assert counts.sum() > 0
    batched = sample_annotated_dense.sample_annotated_dense(True, device="cpu")
    # the device pass pads its last batch of 64 with the last patch, as JAX's
    assert batched.sum() == -(-counts.sum() // 64) * 64 and (batched >= counts).all()
    assert sample_annotated_rnd.sample_annotated_rnd(n_batches=1, device="cpu").sum() == 64
    assert sample_annotated_rnd.sample_annotated_rnd(True, n_batches=1, device="cpu").sum() == 64
    out = extract_patches_for_test_set.extract_patches_for_test_set(
        layer=1, patch_size=96, patches_per_class=2, device="cpu")
    assert out == in_dataset / "patches_test" and len(list(out.rglob("*.jpg"))) > 0
    printed = capsys.readouterr().out
    assert "(8, 224, 224, 3) (8, 2)" in printed and "items/s" in printed


def test_cli_flags_match_the_jax_cli():
    for mod in (predict_full_patched, sample_full_dense, sample_full_random,
                sample_annotated_dense, sample_annotated_rnd, extract_patches_for_test_set):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--help"])
        assert exc.value.code == 0
    with pytest.raises(SystemExit):
        predict_full_patched.main(["--int8", "--host_loop"])
    with pytest.raises(ValueError, match="host_loop"):
        predict_full_patched.predict_full_patched(fcn=True, host_loop=True, device="cpu")


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "best_model.msgpack"
    shapes = jax.eval_shape(jax_get_model(5).init, jax.random.key(0), np.zeros((1, 224, 224, 3)))
    v = _random_variables(shapes, np.random.default_rng(21))
    jck.save_model(path, v["params"], v["batch_stats"])
    return path


def test_predict_cli_dense_serves_a_jax_checkpoint_as_the_jax_cli(
        in_dataset, jax_checkpoint, strict_jax_predict, tmp_path, monkeypatch):  # noqa: F811
    import deephisto_tpu.predict as jax_predict_pkg

    got = predict_full_patched.predict_full_patched(
        jax_checkpoint, dense=True, out_dir=tmp_path / "port", device="cpu")
    assert set(got["paths"]) == {"mask", "original", "overlay"}
    for p in got["paths"].values():
        assert p.suffix == ".jpg" and np.asarray(Image.open(p)).shape == (32, 32, 3)

    seen = {}

    def recording(*args, **kwargs):
        seen["map"], seen["scores"] = strict_jax_predict(*args, **kwargs)
        return seen["map"], seen["scores"]

    monkeypatch.setattr(jax_predict_pkg, "predict_full_fused", recording)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["predict_full_patched", "--dense", "--weights",
                                      str(jax_checkpoint)])
    runpy.run_module("examples.predict_full_patched", run_name="__main__")
    assert (tmp_path / "output" / "test_00_mask.jpg").exists()

    want, scores = np.asarray(seen["map"]), np.asarray(seen["scores"], dtype=np.float32)
    assert got["pred"].shape == want.shape == (32, 32)
    np.testing.assert_array_equal(got["pred"], want)
    np.testing.assert_allclose(got["scores"], scores, rtol=0, atol=0.01 * np.abs(scores).max())


@pytest.mark.parametrize("flags", [{}, {"host_loop": True}, {"host_loop": True, "dense": True},
                                   {"int8": True}, {"int8": True, "fcn": True}])
def test_predict_cli_modes_run_on_the_cpu(in_dataset, jax_checkpoint, tmp_path, flags):
    """Every mode writes its map and the three JPEGs; the random modes cover
    the slide."""
    got = predict_full_patched.predict_full_patched(jax_checkpoint, out_dir=tmp_path, device="cpu",
                                                    **flags)
    assert got["pred"].shape == (32, 32) and got["pred"].dtype == np.uint8
    assert int(got["pred"].max()) < 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "test_00.jpg", "test_00_mask.jpg", "test_00_overlay.jpg"]
    if not flags.get("host_loop") and not flags.get("fcn"):
        assert got["filled"] == 1.0 and got["steps"] >= 1


def test_single_patch_predict_resizes_as_the_jax_cli(tmp_path):
    cfg = {"model": {"n_classes": 5, "depth": 18}, "dataset": {"patch_size": 32}}
    shapes = jax.eval_shape(jax_get_model(5).init, jax.random.key(0), np.zeros((1, 32, 32, 3)))
    v = _random_variables(shapes, np.random.default_rng(8))
    jck.save_model(tmp_path / "best.msgpack", v["params"], v["batch_stats"])
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 256, (200, 300, 3), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / "p.png")
        np.testing.assert_array_equal(port_predict.load_image(tmp_path / "p.png", 32),
                                      jax_predict.load_image(tmp_path / "p.png", 32))
        assert port_predict.predict(tmp_path / "p.png", tmp_path / "best.msgpack", cfg,
                                    device="cpu") == \
            jax_predict.predict(tmp_path / "p.png", tmp_path / "best.msgpack", cfg)
