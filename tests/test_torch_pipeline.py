"""The port's exact dense predict vs the JAX package's ``predict_full_fused``
on a crop of the conftest synthetic slide, with the same narrow float32
ResNet-18 (flax weights converted to torch) and a batch size that leaves a
partial last batch.

The JAX reference is compiled with ``xla_allow_excess_precision`` off. With
it on (XLA's default), XLA-CPU drops the bf16 rounding of ``model_input``
(predict/pipeline.py:42) ahead of an f32 model and feeds it u8/255 in f32,
which moves the scores by ~3e-3; the port rounds through bf16 as the source
says, and as the JAX package does on a TPU.

The score maps must agree to rtol=atol=1e-4 (each cell sums a few logits of
two float32 forwards that order their conv sums differently, see
test_torch_resnet.py). The argmax maps must be equal on every cell whose
top-2 margin exceeds 1e-3; a closer margin can flip under that difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import flax_and_torch_resnet
from test_torch_vit import flax_and_torch_vit

from deephisto_tpu.predict import pipeline as jax_pipeline
from deephisto_tpu.predict.pipeline import dense_coords as jax_dense_coords
from deephisto_tpu.predict.pipeline import model_input as jax_model_input
from deephisto_tpu_torch.predict import dense_coords, model_input, predict_full_fused

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def strict_jax_predict(monkeypatch):
    """The JAX package's predict_full_fused, its scan compiled without
    excess precision (module docstring)."""
    scan = jax_pipeline._predict_scan
    strict = jax.jit(
        scan.__wrapped__,
        static_argnames=("model", "patch_size", "downscale", "n_classes", "softmax",
                         "mesh", "packed", "hw"),
        compiler_options={"xla_allow_excess_precision": False},
    )
    monkeypatch.setattr(jax_pipeline, "_predict_scan", strict)
    return jax_pipeline.predict_full_fused


@pytest.mark.parametrize(
    "ps,stride,d,softmax", [(224, 112, 16, False), (200, 100, 16, True)]
)
def test_predict_full_fused_matches_jax(synthetic_slide, strict_jax_predict, ps, stride, d, softmax):
    slide, _ = synthetic_slide
    img = slide.get_region_from_layer(1, (0, 0), (448, 560))
    jm, v, tm = flax_and_torch_resnet(18, size=ps)
    n_patches = len(dense_coords(448, 560, ps, stride))
    assert n_patches % 7  # the last batch is partial
    want_map, want_scores = strict_jax_predict(
        jnp.asarray(img), jm, v, n_classes=5, patch_size=ps, stride=stride,
        batch_size=7, downscale=d, softmax=softmax,
    )
    got_map, got_scores = predict_full_fused(
        img, tm, n_classes=5, patch_size=ps, stride=stride, batch_size=7,
        downscale=d, softmax=softmax, device="cpu",
    )
    want_scores = np.asarray(want_scores)
    assert got_map.dtype == np.uint8 and got_map.shape == (448 // d, 560 // d)
    assert got_scores.shape == want_scores.shape == (448 // d, 560 // d, 5)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, **TOL)

    top2 = np.sort(want_scores, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert (~decided).sum() <= 0.02 * decided.size, (~decided).sum()
    np.testing.assert_array_equal(got_map[decided], np.asarray(want_map)[decided])


def test_predict_full_fused_with_a_patch8_vit_matches_jax(synthetic_slide, strict_jax_predict):
    """The same crop through a narrow float32 patch-8 ViT with the conv stem
    (784 tokens a patch; random BN, LN and pos_embed): both run their plain
    attention here (no TPU, no card), the bounds of the ResNet case."""
    slide, _ = synthetic_slide
    img = slide.get_region_from_layer(1, (0, 0), (448, 560))
    jm, v, tm = flax_and_torch_vit("conv")
    want_map, want_scores = strict_jax_predict(
        jnp.asarray(img), jm, v, n_classes=5, batch_size=7,
    )
    got_map, got_scores = predict_full_fused(img, tm, n_classes=5, batch_size=7, device="cpu")
    want_scores = np.asarray(want_scores)
    assert got_scores.shape == want_scores.shape == (28, 35, 5)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, **TOL)
    top2 = np.sort(want_scores, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert (~decided).sum() <= 0.02 * decided.size, (~decided).sum()
    np.testing.assert_array_equal(got_map[decided], np.asarray(want_map)[decided])


def test_predict_full_fused_refuses_uint8_models():
    """The refusal of ``wants_uint8`` models is lifted: such a model (the
    int8 ResNet) now gets the raw uint8 patches, through K1's uint8 gather,
    as the JAX ``model_input`` hands them over; a float model still gets
    bf16 u8/255."""
    _, _, tm = flax_and_torch_resnet(18, size=64)
    seen = []
    tm.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    predict_full_fused(img, tm, 5, patch_size=64, device="cpu")
    tm.wants_uint8 = True
    predict_full_fused(img, tm, 5, patch_size=64, device="cpu")
    assert seen == [torch.bfloat16, torch.uint8]


@pytest.mark.parametrize("h,w,ps,stride", [(448, 560, 224, 112), (300, 301, 64, 50), (64, 64, 64, 7)])
def test_dense_coords_match_jax(h, w, ps, stride):
    np.testing.assert_array_equal(dense_coords(h, w, ps, stride), jax_dense_coords(h, w, ps, stride))


def test_model_input_matches_jax():
    u = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    got = model_input(object(), torch.from_numpy(u))
    want = jax_model_input(object(), jnp.asarray(u))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    class WantsU8:
        wants_uint8 = True

    assert model_input(WantsU8(), torch.from_numpy(u)).dtype == torch.uint8


def test_predict_full_fused_checks_its_inputs():
    _, _, tm = flax_and_torch_resnet(18, size=64)
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="n_classes"):
        predict_full_fused(img, tm, 256, patch_size=64, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        predict_full_fused(img.astype(np.float32), tm, 5, patch_size=64, device="cpu")
    with pytest.raises(ValueError, match="smaller than patch_size"):
        predict_full_fused(img, tm, 5, patch_size=128, device="cpu")
