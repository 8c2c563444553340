"""The port's int8 ViT (``deephisto_tpu_torch/models/quantize_vit.py``) and
folded-stem ViT (``models/vit.py:FoldedStemViT``) against the JAX package's
(``deephisto_tpu/models/quantize_vit.py``, ``models/vit.py:268-389``).

Narrow ViTs (patch 8 on 32² inputs: 16 tokens; depth 2; every weight, norm
affine and BN statistic random) with numpy weights shared by both packages.

* ``QuantizedViT`` on the JAX package's own ``qvariables`` carried across
  (``flax_vit_qvariables_to_torch``), for the linear, conv and conv_gn
  stems, on uint8 and float input, at dim 64 with 2 heads: every int8
  operand of every int8 conv and Dense product and every int32 product equal
  bit for bit (recorded in both packages), the f32 logits within 1e-6
  (LayerNorm's statistics and the token mean summed in another order;
  readings <= 4.8e-7). The JAX oracle runs op by op (``jax.disable_jit()``).
* At dim 32 with 2 heads the same models are held with counted flips:
  XLA-CPU's and torch's tanh GELU differ in the last ulp on about a quarter
  of their inputs, and one GELU output of this model sits within that ulp
  of a rounding tie of fc2's input quantize (measured); every operand up to
  the first fc2 stays equal, the flips after it are at most 2 (a flip moves
  later sums) and under 2 % of a tensor, the logits within 1e-2 of the
  largest.
* The port's own ``calibrate_vit``: every absmax within 1e-6 relative
  (the float forward summed in another order; readings <= 4.9e-7); its
  ``quantize_vit`` from the JAX package's absmax gives the JAX package's
  ``qvariables`` bit for bit.
* The uint8 input table (``input_lut``) is the source's input quantize
  ``clip(round(f32(u8)·f32(inv/255)))`` on all 256 bytes.
* The int8 ViT through ``predict_full_fused`` (K1's int8 mode in the
  ``hwc`` layout, then the model) against the JAX package's predict of the
  same ``qvariables``: on these patches the GELU's ulp flips a few
  requants, so the scores are held within 1e-2 of the largest and the maps
  equal wherever the JAX package's two top scores are 1e-2 apart.
* ``FoldedStemViT``: the folded tensors equal the JAX package's bit for bit
  (float64 on the host in both), the bf16 logits within 2e-2 of the largest
  and the same argmax against the JAX ``FoldedStemViT`` and against the
  port's unfolded bf16 model (``tests/test_vit.py``'s bound for the JAX
  rewrite), on uint8 and float input.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _random_variables

from deephisto_tpu.models.vit import ViT as JViT
from deephisto_tpu.models.vit import fold_vit_stem as jax_fold
from deephisto_tpu.predict import pipeline as jpipe
from deephisto_tpu_torch.models import (
    FoldedStemViT,
    QuantizedViT,
    ViT,
    flax_folded_stem_to_torch,
    flax_vit_qvariables_to_torch,
    flax_vit_to_torch,
    fold_vit_stem,
    quantize_model,
    quantize_vit,
)
from deephisto_tpu_torch.ops import conv_int8 as tconv
from deephisto_tpu_torch.predict import pipeline as tpipe
from deephisto_tpu_torch.predict import predict_full_fused

jqv = importlib.import_module("deephisto_tpu.models.quantize_vit")
tqv = importlib.import_module("deephisto_tpu_torch.models.quantize_vit")

PS, NC = 32, 5
STEMS = ["linear", "conv", "conv_gn"]
_CACHE = {}


def _pair(stem, dim=64, heads=2):
    """(flax module, numpy variables, the port's float32 ViT on them, the
    JAX package's quantized model and its qvariables, calibration batches),
    made once per (stem, dim, heads)."""
    key = (stem, dim, heads)
    if key not in _CACHE:
        jm = JViT(num_classes=NC, patch=8, dim=dim, depth=2, heads=heads, stem=stem,
                  dtype=jnp.float32)
        shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, PS, PS, 3)))
        v = _random_variables(shapes, np.random.default_rng(0))
        tm = ViT(NC, patch=8, dim=dim, depth=2, heads=heads, stem=stem, dtype=torch.float32,
                 img_size=PS)
        tm.load_state_dict(flax_vit_to_torch(v))
        calib = [np.random.default_rng(1).random((4, PS, PS, 3)).astype(np.float32)]
        qm, qv = jqv.quantize_vit(jm, jax.tree.map(jnp.asarray, v), calib)
        _CACHE[key] = (jm, v, tm.eval(), qm, qv, calib)
    return _CACHE[key]


def _ported(qv, tm):
    return QuantizedViT(tm, flax_vit_qvariables_to_torch(jax.tree.map(np.asarray, qv)))


def _input(kind, n=8, seed=2):
    u8 = np.random.default_rng(seed).integers(0, 256, (n, PS, PS, 3), dtype=np.uint8)
    return u8 if kind == "u8" else u8.astype(np.float32) / 255.0


def _recorded_forwards(qm, qv, tq, x):
    """Both forwards on ``x``, each int8 product's (int8 operand, int32
    result) recorded in order: the JAX package's through ``jax.lax``'s
    ``dot_general`` and ``conv_general_dilated`` (the only int8 products of
    ``QuantizedViT.apply``), the port's through ``int8_matmul`` and K6's
    plain s8 conv. Returns (jax logits, port logits, jax records, port
    records)."""
    jrec, trec = [], []
    dg, cg = jax.lax.dot_general, jax.lax.conv_general_dilated

    def rec(fn, log):
        def wrapped(a, b, *args, **kw):
            y = fn(a, b, *args, **kw)
            log.append((np.asarray(a).reshape(-1), np.asarray(y).reshape(-1)))
            return y
        return wrapped

    mm, s32 = tqv.int8_matmul, tconv.conv_s32_ref
    jax.lax.dot_general, jax.lax.conv_general_dilated = rec(dg, jrec), rec(cg, jrec)
    tqv.int8_matmul = lambda a, b: rec(mm, trec)(a, b)
    tconv.conv_s32_ref = lambda a, b, s, p: rec(s32, trec)(a, b, s, p)
    try:
        with jax.disable_jit():
            want = np.asarray(qm.apply(qv, jnp.asarray(x)))
        got = tq(torch.from_numpy(x)).numpy()
    finally:
        jax.lax.dot_general, jax.lax.conv_general_dilated = dg, cg
        tqv.int8_matmul, tconv.conv_s32_ref = mm, s32
    return want, got, jrec, trec


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("stem", STEMS)
def test_quantized_vit_is_jax_bit_for_bit_on_its_qvariables(stem, kind):
    _, _, tm, qm, qv, _ = _pair(stem)
    want, got, jrec, trec = _recorded_forwards(qm, qv, _ported(qv, tm), _input(kind))
    n_products = 2 * 4 + 1 + (3 if stem != "linear" else 0)  # Dense a block, embed, stems
    assert len(jrec) == len(trec) == n_products
    for i, ((ja, jy), (ta, ty)) in enumerate(zip(jrec, trec)):
        assert ja.dtype == ta.dtype == np.int8, i
        np.testing.assert_array_equal(ta, ja, err_msg=f"int8 operand of product {i}")
        np.testing.assert_array_equal(ty, jy, err_msg=f"int32 product {i}")
    assert got.dtype == np.float32 and got.shape == (8, NC)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stem", ["conv", "conv_gn"])
def test_quantized_vit_at_dim32_with_counted_flips(stem):
    _, _, tm, qm, qv, _ = _pair(stem, dim=32, heads=2)
    want, got, jrec, trec = _recorded_forwards(qm, qv, _ported(qv, tm), _input("u8"))
    first_fc2 = len(jrec) - 5  # embed/stems, then (qkv, proj, fc1, fc2) twice
    for i, ((ja, jy), (ta, ty)) in enumerate(zip(jrec, trec)):
        if i < first_fc2:
            np.testing.assert_array_equal(ta, ja, err_msg=f"int8 operand of product {i}")
            np.testing.assert_array_equal(ty, jy, err_msg=f"int32 product {i}")
        diff = np.abs(ta.astype(np.int32) - ja)
        assert diff.max() <= 2 and (diff > 0).mean() < 0.02, (i, int((diff > 0).sum()))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("stem", STEMS)
def test_calibrate_vit_matches_jax(stem):
    jm, v, tm, _, _, calib = _pair(stem)
    want = jqv.calibrate_vit(jm, jax.tree.map(jnp.asarray, v), calib)
    got = tqv.calibrate_vit(tm, calib)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("stem", STEMS)
def test_quantize_vit_from_jax_absmax_is_jax_bit_for_bit(stem, monkeypatch):
    """From the JAX package's absmax (and, for the conv stem, its folded
    stem: ``lax.rsqrt`` on XLA-CPU and ``torch.rsqrt`` can be an ulp apart,
    as test_torch_quantize.py measures for the ResNet's fold) the port's
    quantization is the JAX package's bit for bit."""
    jm, v, tm, _, qv, calib = _pair(stem)
    jv = jax.tree.map(jnp.asarray, v)
    absmax = jqv.calibrate_vit(jm, jv, calib)
    monkeypatch.setattr(tqv, "calibrate_vit", lambda model, batches: absmax)
    folded = [(torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy()),
               torch.from_numpy(np.asarray(b))) for w, b in jqv._fold_stem(jm, jv)]
    monkeypatch.setattr(tqv, "_folded_stem", lambda model: folded)
    got = quantize_vit(tm, calib)
    want = _ported(qv, tm)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert set(sd_got) == set(sd_want)
    for k in sd_want:
        assert sd_got[k].dtype == sd_want[k].dtype, k
        assert torch.equal(sd_got[k], sd_want[k]), k


@pytest.mark.parametrize("stem", STEMS)
def test_quantize_vit_tracks_jax(stem):
    """The port's own calibration and quantization end to end: logits
    within 1e-2 of the largest of the JAX package's (an absmax an ulp apart
    can move a weight across a rounding tie)."""
    _, _, tm, qm, qv, calib = _pair(stem)
    x = _input("u8")
    with jax.disable_jit():
        want = np.asarray(qm.apply(qv, jnp.asarray(x)))
    got = quantize_vit(tm, calib)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_quantize_model_dispatches_a_vit():
    _, _, tm, _, _, calib = _pair("linear")
    q = quantize_model(tm, calib)
    assert isinstance(q, QuantizedViT) and q.wants_uint8
    n_int8 = sum(1 for b in q.buffers() if b.dtype == torch.int8 and b.ndim > 1)
    assert n_int8 == 1 + 4 * 2  # the embed conv and (qkv, proj, fc1, fc2) a block
    assert q.input_layout() == ("hwc", False)
    with pytest.raises(ValueError, match="packed"):
        q.input_layout(True)


@pytest.mark.parametrize("stem", STEMS)
def test_input_lut_is_the_source_quantize_on_all_256_bytes(stem):
    _, _, tm, _, qv, _ = _pair(stem)
    first = "stem0" if stem != "linear" else "embed"
    inv = jnp.asarray(qv["params"][first]["in_inv_scale"])
    u8 = jnp.arange(256, dtype=jnp.uint8)
    with jax.disable_jit():
        want = jnp.clip(jnp.round(u8.astype(jnp.float32) * (inv / 255.0)), -127, 127)
    q = _ported(qv, tm)
    np.testing.assert_array_equal(q.input_lut.numpy(), np.asarray(want.astype(jnp.int8)))
    assert torch.equal(q.quantize_input(torch.arange(256, dtype=torch.uint8)), q.input_lut)
    assert torch.equal(q.quantize_input(q.input_lut), q.input_lut)  # int8 passes through


@pytest.mark.parametrize("stem", ["linear", "conv"])
def test_int8_vit_predict_full_fused_matches_jax(stem, monkeypatch):
    _, _, tm, qm, qv, _ = _pair(stem)
    q = _ported(qv, tm)
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 128, (4, 4, 3))
    img = (rng.integers(0, 128, (96, 112, 3)) + np.kron(blocks, np.ones((24, 28, 1))))
    img = img.astype(np.uint8)
    kw = dict(patch_size=PS, stride=16, batch_size=8, downscale=16)
    layouts, dtypes = [], set()
    gather = tpipe.gather_quantize_int8

    def spy(images, slide_idx, coords, ps, lut, layout):
        layouts.append(layout)
        return gather(images, slide_idx, coords, ps, lut, layout)

    monkeypatch.setattr(tpipe, "gather_quantize_int8", spy)
    hook = q.register_forward_pre_hook(lambda m, args: dtypes.add(args[0].dtype))
    try:
        got_map, got_score = predict_full_fused(img, q, NC, device="cpu", **kw)
    finally:
        hook.remove()
    assert set(layouts) == {"hwc"} and dtypes == {torch.int8}
    with jax.disable_jit():
        want_map, want_score = jpipe.predict_full_fused(img, qm, qv, NC, **kw)
    want_score = np.asarray(want_score)
    # the GELU's last-ulp difference flips a few requants on these patches
    # (module docstring): scores within 1e-2 of the largest, the maps equal
    # wherever the JAX package's two top scores are 1e-2 apart
    assert np.abs(got_score.numpy() - want_score).max() <= 1e-2 * np.abs(want_score).max()
    top2 = np.sort(want_score, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-2
    assert decided.mean() >= 0.9
    np.testing.assert_array_equal(got_map[decided], np.asarray(want_map)[decided])


# --------------------------------------------------------------------------
# FoldedStemViT


def _bf16_models():
    """The JAX ViT and the port's, conv stem, bf16, on the same weights."""
    if "bf16" not in _CACHE:
        jm, v, tm, _, _, _ = _pair("conv")
        jb = JViT(num_classes=NC, patch=8, dim=64, depth=2, heads=2, stem="conv")
        tb = ViT(NC, patch=8, dim=64, depth=2, heads=2, stem="conv", img_size=PS)
        tb.load_state_dict(tm.state_dict())
        _CACHE["bf16"] = (jb, v, tb.eval())
    return _CACHE["bf16"]


def test_fold_vit_stem_matches_jax_fold_bit_for_bit():
    jb, v, tb = _bf16_models()
    fm = fold_vit_stem(tb)
    assert isinstance(fm, FoldedStemViT) and fm.wants_uint8 and fm.inner is tb
    _, fv = jax_fold(jb, jax.tree.map(jnp.asarray, v))
    want = flax_folded_stem_to_torch(jax.tree.map(np.asarray, fv))
    got = {k: t for k, t in fm.state_dict().items() if not k.startswith("inner.")}
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the bridge builds the same module from the JAX package's variables
    bridged = FoldedStemViT(tb, want)
    x = torch.from_numpy(_input("u8", n=4))
    with torch.no_grad():
        assert torch.equal(bridged(x), fm(x))


@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_folded_stem_vit_matches_jax_and_the_unfolded_model(kind):
    jb, v, tb = _bf16_models()
    fm = fold_vit_stem(tb)
    jfm, fv = jax_fold(jb, jax.tree.map(jnp.asarray, v))
    x = _input(kind)
    with torch.no_grad():
        got = fm(torch.from_numpy(x)).numpy()
        unfolded = tb(torch.from_numpy(_input("f32"))).numpy()
    apply = jax.jit(jfm.apply, compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(apply(fv, jnp.asarray(x)))
    for ref in (want, unfolded):
        assert np.abs(got - ref).max() < 2e-2 * np.abs(ref).max()
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_folded_stem_vit_through_predict_full_fused():
    """The folded ViT takes raw bytes (K1's uint8 mode) in the dense predict,
    and serves the unfolded model's map."""
    _, _, tb = _bf16_models()
    fm = fold_vit_stem(tb)
    dtypes = set()
    hook = fm.register_forward_pre_hook(lambda m, args: dtypes.add(args[0].dtype))
    img = np.random.default_rng(6).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    kw = dict(patch_size=PS, stride=16, batch_size=8, downscale=16, device="cpu")
    try:
        got, _ = predict_full_fused(img, fm, NC, **kw)
    finally:
        hook.remove()
    assert dtypes == {torch.uint8}
    want, _ = predict_full_fused(img, tb, NC, **kw)
    assert (got == want).mean() >= 0.9


def test_fold_vit_stem_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="stem='conv'"):
        fold_vit_stem(ViT(NC, stem="linear", dim=32, depth=1, heads=2))
    with pytest.raises(ValueError, match="stem='conv'"):
        FoldedStemViT(ViT(NC, stem="conv_gn", dim=32, depth=1, heads=2), {})
    fm = fold_vit_stem(_bf16_models()[2])
    with pytest.raises(ValueError, match="even"):
        fm(torch.zeros((1, 31, 32, 3), dtype=torch.uint8))
