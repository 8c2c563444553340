"""The port's int8 predicts against the JAX package's: the fcn serving mode
(``predict/fcn.py:predict_full_fcn``, raw and staged, pack 4 and 8, with and
without ``pre_tile``) and the exact dense predict on the int8 ResNet
(``predict_full_fused`` on a ``wants_uint8`` model and on a
``PackedSlide``), on a seeded 480² slide with a full-width ResNet-18 (s2d
stem, random BN) quantized by the JAX package, its ``qvariables`` carried
across.

The JAX oracles run under ``jax.disable_jit()``, op by op: XLA-CPU's jitted
programs contract the int8 epilogue's ``a·b + c`` into fused multiply-adds,
which the source's op order (and the port, and its kernel K6) does not do,
so a requant flips by one and the scores move by ~1e-3 (see
test_torch_quantize.py). Op by op, the maps are equal and the fcn scores
agree to 1e-5 (the 7×7 pools and the fc's sums run in another order); the
exact path's scores, sums of up to four logits, to 2e-5. The port's staged
variants give its raw-image result bit for bit, as the JAX package's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import flax_and_torch_resnet

from deephisto_tpu.models.quantize import quantize_resnet as jax_quantize
from deephisto_tpu.predict import fcn as jfcn
from deephisto_tpu.predict import pipeline as jpipe
from deephisto_tpu_torch.models.convert import flax_qvariables_to_torch
from deephisto_tpu_torch.models.quantize import QuantizedResNet
from deephisto_tpu_torch.predict import (
    fcn_equivalent_patches,
    predict_full_fcn,
    predict_full_fused,
    s2d_pack_image,
    stage_for_fcn,
    stage_packed_slide,
)
from deephisto_tpu_torch.predict import fcn as tfcn
from deephisto_tpu_torch.predict import pipeline as tpipe

H = W = 480
TILE, HALO = 256, 32
FCN_TOL = dict(rtol=0, atol=1e-5)
EXACT_TOL = dict(rtol=0, atol=2e-5)

_CACHE = {}


def _setup():
    """(JAX int8 model, its qvariables, the port's pack_l1 QuantizedResNet
    on them, the slide): uniform noise over random block colours."""
    if "setup" not in _CACHE:
        jm, v, tm = flax_and_torch_resnet(18, stem="s2d", num_filters=64, size=64)
        rng = np.random.default_rng(0)
        calib = [rng.random((2, 64, 64, 3)).astype(np.float32)]
        # the JAX oracle runs its unpacked trunk, which it documents (and
        # tests) as bit-identical to pack_l1's, at 0.56x the stage-1 MACs
        qm, qv = jax_quantize(jm, jax.tree.map(jnp.asarray, v), calib)
        qparams = flax_qvariables_to_torch(jax.tree.map(np.asarray, qv))
        tq = QuantizedResNet(tm, qparams, pack_l1=True)
        _CACHE["unpacked"] = QuantizedResNet(tm, qparams)
        blocks = rng.integers(0, 128, (4, 4, 3))
        img = rng.integers(0, 128, (H, W, 3)) + np.kron(blocks, np.ones((120, 120, 1)))
        _CACHE["setup"] = (qm, qv, tq, img.astype(np.uint8))
    return _CACHE["setup"]


def _jax_fcn():
    """The JAX package's fcn predict of the raw slide, op by op."""
    if "fcn" not in _CACHE:
        qm, qv, _, img = _setup()
        with jax.disable_jit():
            am, sc = jfcn.predict_full_fcn(jnp.asarray(img), qm, qv, n_classes=5, tile=TILE,
                                           halo=HALO, tile_batch=4)
        _CACHE["fcn"] = (np.asarray(am), np.asarray(sc))
    return _CACHE["fcn"]


def _staged(kind, img):
    if kind == "raw":
        return img
    if kind == "raw tensor":
        return torch.from_numpy(img)
    pack = 8 if "pack8" in kind else 4
    src = torch.from_numpy(img) if "device" in kind else img
    return stage_for_fcn(src, tile=TILE, halo=HALO, pack=pack, pre_tile="tiled" in kind,
                         device="cpu")


FCN_KINDS = ["raw", "raw tensor", "pack4", "pack4 tiled", "pack8", "pack8 tiled",
             "pack8 device", "pack8 tiled device"]


def _int8_route(monkeypatch, module, model):
    """Record the layouts K1's int8 mode is called with from ``module``'s
    predict and the dtypes the int8 model is handed."""
    seen = {"layouts": [], "dtypes": set()}
    gather = module.gather_quantize_int8

    def spy(images, slide_idx, coords, ps, lut, layout):
        seen["layouts"].append(layout)
        return gather(images, slide_idx, coords, ps, lut, layout)

    monkeypatch.setattr(module, "gather_quantize_int8", spy)
    hook = model.register_forward_pre_hook(lambda m, args: seen["dtypes"].add(args[0].dtype))
    return seen, hook


@pytest.mark.parametrize("kind", FCN_KINDS)
def test_predict_full_fcn_matches_jax(kind, monkeypatch):
    """Through K1's int8 mode (the model is handed int8 tiles in its stem's
    4×4 form, quantized by the gather), every staging gives the JAX
    package's map, and the port's raw-image scores bit for bit."""
    _, _, tq, img = _setup()
    want_map, want_score = _jax_fcn()
    seen, hook = _int8_route(monkeypatch, tfcn, tq)
    try:
        got_map, got_score = predict_full_fcn(_staged(kind, img), tq, 5, tile=TILE, halo=HALO,
                                              tile_batch=3, device="cpu")
    finally:
        hook.remove()
    layout = "s2d8_to_s2d4" if "pack8" in kind else "hwc" if "pack4" in kind else "s2d4"
    assert set(seen["layouts"]) == {layout} and seen["dtypes"] == {torch.int8}
    assert got_map.dtype == np.uint8 and got_map.shape == (H // 16, W // 16)
    np.testing.assert_array_equal(got_map, want_map)
    np.testing.assert_allclose(got_score.numpy(), want_score, **FCN_TOL)
    if kind == "raw":
        _CACHE["port raw"] = got_score
    elif "port raw" in _CACHE:  # every staging gives the raw-image scores bit for bit
        assert torch.equal(got_score, _CACHE["port raw"])


def test_predict_full_fcn_does_not_depend_on_tile_batch():
    _, _, tq, img = _setup()
    staged = _staged("pack8 tiled", img)
    a = predict_full_fcn(staged, tq, 5, tile=TILE, halo=HALO, tile_batch=1, device="cpu")
    b = predict_full_fcn(staged, tq, 5, tile=TILE, halo=HALO, tile_batch=16, scan_unroll=2,
                         scan_prefetch=True, device="cpu")
    assert np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("packed", [False, True])
def test_exact_int8_predict_matches_jax(packed, monkeypatch):
    """The exact dense predict on the int8 ResNet (K1's int8 mode, which
    hands the model quantized 4×4 windows, the int8 forward, K2), raw and
    from a PackedSlide, against the JAX package's on a 448 × 336 crop with a
    partial last batch."""
    qm, qv, tq, img = _setup()
    crop = np.ascontiguousarray(img[:448, :336])
    if "exact" not in _CACHE:
        with jax.disable_jit():
            am, sc = jpipe.predict_full_fused(jnp.asarray(crop), qm, qv, n_classes=5,
                                              batch_size=4)
        _CACHE["exact"] = (np.asarray(am), np.asarray(sc))
    want_map, want_score = _CACHE["exact"]
    image = stage_packed_slide(crop, device="cpu") if packed else crop
    seen, hook = _int8_route(monkeypatch, tpipe, tq)
    try:
        got_map, got_score = predict_full_fused(image, tq, 5, batch_size=4, device="cpu")
    finally:
        hook.remove()
    assert set(seen["layouts"]) == {"hwc" if packed else "s2d4"}
    assert seen["dtypes"] == {torch.int8}
    np.testing.assert_array_equal(got_map, want_map)
    np.testing.assert_allclose(got_score.numpy(), want_score, **EXACT_TOL)


def test_packed_slide_falls_back_to_raw_on_a_misaligned_grid():
    _, _, tq, img = _setup()
    crop = np.ascontiguousarray(img[:230, :229])  # the last row/col coords are not 4-aligned
    want = predict_full_fused(crop, tq, 5, batch_size=4, device="cpu")
    got = predict_full_fused(stage_packed_slide(crop, device="cpu"), tq, 5, batch_size=4,
                             device="cpu")
    assert np.array_equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="keep_raw"):
        predict_full_fused(stage_packed_slide(crop, keep_raw=False, device="cpu"), tq, 5,
                           device="cpu")


@pytest.mark.parametrize("pack,pre_tile", [(4, False), (4, True), (8, False), (8, True)])
def test_stage_for_fcn_matches_jax(pack, pre_tile):
    """Host and device staging give the JAX package's staged tensors bit
    for bit (edge padding, the 4×4 and 8×8 packs, the tile grid)."""
    img = _setup()[3][:300, :420]
    want = jfcn.stage_for_fcn(img, tile=TILE, halo=HALO, pack=pack, pre_tile=pre_tile)
    want = np.asarray(want.tiles if pre_tile else want.packed)
    for src in (img, torch.from_numpy(np.ascontiguousarray(img))):
        got = stage_for_fcn(src, tile=TILE, halo=HALO, pack=pack, pre_tile=pre_tile,
                            device="cpu")
        got = got.tiles if pre_tile else got.packed
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_helpers_match_jax():
    img = _setup()[3][:64, :96]
    p4 = s2d_pack_image(torch.from_numpy(img))
    np.testing.assert_array_equal(p4.numpy(), np.asarray(jfcn.s2d_pack_image(jnp.asarray(img))))
    np.testing.assert_array_equal(tfcn._pack2_device(p4).numpy(),
                                  np.asarray(jfcn._pack2_device(jnp.asarray(p4.numpy()))))
    np.testing.assert_array_equal(tfcn._host_pack_s2d(img, 8), jfcn._host_pack_s2d(img, 8))
    assert fcn_equivalent_patches(1000, 700) == jfcn.fcn_equivalent_patches(1000, 700)


@pytest.mark.parametrize("shape", [(9, 11), (4, 4), (13, 6)])
def test_window_pool_and_ensemble_match_jax(shape):
    """B6 on torch ops: the 7×7 pool and the trailing window ensemble (with
    tail cells past the last window) against the JAX package's, to f32
    rounding of sums taken in another order."""
    rng = np.random.default_rng(sum(shape))
    logit_map = rng.normal(0, 3, shape + (5,)).astype(np.float32)
    got = tfcn._avg_pool_f32(torch.from_numpy(logit_map), 3).numpy()
    want = np.asarray(jax.jit(jfcn._avg_pool_f32, static_argnums=1)(jnp.asarray(logit_map), 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ky, kx = shape[0] - 2, shape[1] - 2
    mh, mw = 2 * shape[0] + 3, 2 * shape[1] + 1
    got_map, got_score = tfcn._window_ensemble(torch.from_numpy(want), 3, 2, ky, kx, mh, mw)
    want_map, want_score = jax.jit(jfcn._window_ensemble, static_argnums=range(1, 7))(
        jnp.asarray(want), 3, 2, ky, kx, mh, mw)
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))


def test_fcn_refuses_what_the_jax_package_refuses():
    _, _, tq, img = _setup()
    plain = _CACHE["unpacked"]
    staged8 = stage_for_fcn(img, tile=TILE, halo=HALO, pack=8, device="cpu")
    with pytest.raises(ValueError, match="pack_l1"):
        predict_full_fcn(staged8, plain, 5, tile=TILE, halo=HALO, device="cpu")
    with pytest.raises(ValueError, match="staged for tile"):
        predict_full_fcn(staged8, tq, 5, tile=2 * TILE, halo=HALO, device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        predict_full_fcn(img, tq, 5, tile=TILE, halo=HALO + 1, device="cpu")
    with pytest.raises(ValueError, match="n_classes"):
        predict_full_fcn(img, tq, 256, tile=TILE, halo=HALO, device="cpu")
