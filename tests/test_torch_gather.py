"""Patch gather port vs the JAX package: the u8 gathers vs
``gather_patches_xla``/``gather_patches_multi_xla``, and K1's plain version
vs the Pallas kernel (interpret mode, f32) and vs ``model_input ∘
gather_patches_xla`` (bf16), bit for bit. The kernel itself runs only on a
card (test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.experimental.pallas_gather import gather_normalize_pallas, stage_slide
from deephisto_tpu.ops.gather import gather_patches_multi_xla, gather_patches_xla
from deephisto_tpu.predict.pipeline import model_input as jax_model_input
from deephisto_tpu_torch import _build
from deephisto_tpu_torch.ops import (
    gather_normalize,
    gather_normalize_ref,
    gather_patches,
    gather_patches_multi,
    u8_table,
)


def _image(h=300, w=400, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _coords(h, w, ps, n=12, seed=1):
    rng = np.random.default_rng(seed)
    fixed = [(0, 0), (h - ps, w - ps), (h - ps, 7), (5, w - ps), (17, 33)]
    rand = [(rng.integers(0, h - ps + 1), rng.integers(0, w - ps + 1)) for _ in range(n)]
    return np.asarray(fixed + rand, dtype=np.int32)


def test_u8_tables_match_jax_for_all_256_values():
    u = jnp.arange(256, dtype=jnp.uint8)
    want_bf16 = np.asarray(jax_model_input(object(), u).astype(jnp.float32))
    want_f32 = np.asarray(u.astype(jnp.float32) * (1.0 / 255.0))
    got_bf16 = u8_table(torch.bfloat16)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf16.float().numpy(), want_bf16)
    np.testing.assert_array_equal(u8_table(torch.float32).numpy(), want_f32)


def test_gather_normalize_f32_matches_pallas_interpret():
    img = np.array(stage_slide(_image()))  # the Pallas kernel needs staging slack
    coords = np.array([[0, 0], [17, 33], [200, 111], [236, 336]], dtype=np.int32)
    want = np.asarray(
        gather_normalize_pallas(jnp.asarray(img), jnp.asarray(coords), 64, interpret=True)
    )
    got = gather_normalize(torch.from_numpy(img), torch.from_numpy(coords), 64, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("channels", [3, 48])
def test_gather_normalize_bf16_matches_model_input(channels):
    img = _image(c=channels)
    coords = _coords(300, 400, 56)
    want = jax_model_input(object(), gather_patches_xla(jnp.asarray(img), jnp.asarray(coords), 56))
    got = gather_normalize(torch.from_numpy(img), torch.from_numpy(coords), 56, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (len(coords), 56, 56, channels)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, gather_normalize_ref(torch.from_numpy(img), coords, 56))


def test_gather_patches_matches_xla_including_clamped_starts():
    img = _image()
    # dynamic_slice wraps negative starts, then clamps; so does the port
    extra = [[290, -5], [-3, 399], [250, 10], [10, -4], [-400, 0]]
    coords = np.concatenate([_coords(300, 400, 64), extra]).astype(np.int32)
    want = np.asarray(gather_patches_xla(jnp.asarray(img), jnp.asarray(coords), 64))
    got = gather_patches(torch.from_numpy(img), torch.from_numpy(coords), 64)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_patches_multi_matches_xla():
    imgs = np.stack([_image(seed=0), _image(seed=1), _image(seed=2)])
    coords = np.concatenate([_coords(300, 400, 32), [[-3, 390], [299, 5]]]).astype(np.int32)
    sidx = np.random.default_rng(2).integers(-4, 5, len(coords)).astype(np.int32)
    want = np.asarray(
        gather_patches_multi_xla(jnp.asarray(imgs), jnp.asarray(sidx), jnp.asarray(coords), 32)
    )
    got = gather_patches_multi(torch.from_numpy(imgs), sidx, coords, 32)
    np.testing.assert_array_equal(got.numpy(), want)


# coords that leave a 300x400 slide for 64-px patches, on each side, negative
# ones included; lax.dynamic_slice counts a negative start from the end and
# then clamps the patch inside the slide
OFF_SLIDE = [[-1, 0], [0, -1], [300 - 63, 0], [0, 400 - 63], [-64, -400], [-301, 5],
             [299, 399], [5000, -5000], [-7, 200], [150, 350]]


def _jax_normalized(img, coords, ps, dtype):
    """The JAX package's patches of ``u8 / 255`` at ``coords``: bf16 as
    ``model_input ∘ gather_patches_xla``, f32 as the Pallas kernel scales
    (``u8 · f32(1/255)``)."""
    u8 = gather_patches_xla(jnp.asarray(img), jnp.asarray(coords), ps)
    if dtype == torch.bfloat16:
        return np.asarray(jax_model_input(object(), u8).astype(jnp.float32))
    return np.asarray(u8).astype(np.float32) * np.float32(1.0 / 255.0)


@pytest.mark.parametrize(
    "coords,match",
    [([[0, 0], [300 - 63, 0]], "out of range"), ([[-1, 0]], "out of range"),
     ([[0, 400 - 63]], "out of range")],
)
def test_gather_normalize_rejects_coords_off_the_slide(coords, match):
    """Coords off the slide are not refused (``match`` is unused): K1 clamps
    them as the JAX package's gather does."""
    img = _image()
    got = gather_normalize(torch.from_numpy(img), torch.tensor(coords, dtype=torch.int32), 64)
    want = _jax_normalized(img, np.asarray(coords, np.int32), 64, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_normalize_clamps_coords_off_the_slide_as_jax(dtype):
    img = _image()
    coords = np.concatenate([_coords(300, 400, 64), OFF_SLIDE]).astype(np.int32)
    got = gather_normalize(torch.from_numpy(img), torch.from_numpy(coords), 64, dtype)
    assert got.dtype == dtype and got.shape == (len(coords), 64, 64, 3)
    np.testing.assert_array_equal(got.float().numpy(), _jax_normalized(img, coords, 64, dtype))


def test_gather_normalize_rejects_bad_inputs():
    img = torch.from_numpy(_image())
    ok = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gather_normalize(img, ok.long(), 8)
    with pytest.raises(ValueError, match="uint8"):
        gather_normalize(img.float(), ok, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gather_normalize(img.transpose(0, 1), ok, 8)
    with pytest.raises(ValueError, match="out_dtype"):
        gather_normalize(img, ok, 8, torch.float16)


def test_cpu_tensors_take_the_plain_version():
    _build.reset_launches()
    img = torch.from_numpy(_image())
    gather_normalize(img, torch.zeros((2, 2), dtype=torch.int32), 16)
    assert _build.launches.get("gather_normalize", 0) == 0
