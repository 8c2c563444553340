"""The port's streamed predicts (``deephisto_tpu_torch/predict/streaming.py``)
against its resident predicts and the JAX package's streamed ones.

A narrow ResNet (BasicBlock, stages (1, 1, 1, 1), 8 filters, s2d stem, every
BN statistic random) with numpy weights shared by both packages:

* streamed vs resident in the port: the maps and the score maps equal bit
  for bit (``torch.equal``), for the float model and the int8 one, in the
  cases of ``tests/test_predict.py:154-215`` and ``tests/test_fcn.py:
  196-250``: several stripes, one stripe, the exact stripe boundary (h - ps a
  multiple of the owned rows), odd sizes, pack 4 and pack 8 (the pack_l1
  int8 model), and ``prestage_all`` with its ``timings``;
* streamed vs the JAX package's streamed predict on the JAX package's own
  int8 ``qvariables`` carried across (the int8 convs are exact in both, so
  the float paths' summation orders cannot move a class): the maps equal,
  the score maps within 1e-5 (fcn: the 7×7 pools and the fc's sums run in
  another order) and 2e-5 (dense: sums of up to four logits). The JAX
  oracle runs op by op (``jax.disable_jit()``), as ``test_torch_fcn.py``
  explains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _random_variables

from deephisto_tpu.models.quantize import quantize_resnet as jax_quantize
from deephisto_tpu.models.resnet import BasicBlock as JBasicBlock
from deephisto_tpu.models.resnet import ResNet as JResNet
from deephisto_tpu.predict import streaming as jstream
from deephisto_tpu_torch.models import flax_resnet_to_torch
from deephisto_tpu_torch.models.convert import flax_qvariables_to_torch
from deephisto_tpu_torch.models.quantize import QuantizedResNet
from deephisto_tpu_torch.models.resnet import BasicBlock, ResNet
from deephisto_tpu_torch.predict import (
    predict_full_fcn,
    predict_full_fcn_streamed,
    predict_full_fused,
    predict_full_streamed,
)
from deephisto_tpu_torch.predict.streaming import _stripe_plan

NC, PS, D = 5, 64, 16
FCN = dict(tile=64, halo=32)
FCN_TOL = dict(rtol=0, atol=1e-5)
DENSE_TOL = dict(rtol=0, atol=2e-5)
_CACHE = {}


def narrow_resnet(stem="s2d", seed=0):
    """(flax module, its random numpy variables, the port's float32 model
    on them in eval mode): BasicBlock, stages (1, 1, 1, 1), 8 filters."""
    jm = JResNet(stage_sizes=(1, 1, 1, 1), block_cls=JBasicBlock, num_classes=NC,
                 num_filters=8, dtype=jnp.float32, stem=stem)
    shapes = jax.eval_shape(jm.init, jax.random.key(seed), jnp.zeros((1, PS, PS, 3)))
    v = _random_variables(shapes, np.random.default_rng(seed))
    tm = ResNet((1, 1, 1, 1), BasicBlock, NC, num_filters=8, dtype=torch.float32, stem=stem)
    tm.load_state_dict(flax_resnet_to_torch(v))
    return jm, v, tm.eval()


def narrow_int8(stem="s2d"):
    """(JAX int8 model, its qvariables, the port's unpacked and pack_l1
    QuantizedResNet on them, the port's bf16 float model), made once a
    stem."""
    if stem not in _CACHE:
        jm, v, tm = narrow_resnet(stem)
        calib = [np.random.default_rng(1).random((2, PS, PS, 3)).astype(np.float32)]
        qm, qv = jax_quantize(jm, jax.tree.map(jnp.asarray, v), calib)
        qparams = flax_qvariables_to_torch(jax.tree.map(np.asarray, qv))
        bf16 = ResNet((1, 1, 1, 1), BasicBlock, NC, num_filters=8, stem=stem)
        bf16.load_state_dict(tm.state_dict())
        _CACHE[stem] = (qm, qv, QuantizedResNet(tm, qparams),
                        QuantizedResNet(tm, qparams, pack_l1=True), bf16.eval())
    return _CACHE[stem]


def _image(h, w, seed=3):
    """Uniform noise over random block colours, so the map has classes."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 128, (4, 4, 3))
    big = np.kron(blocks, np.ones((-(-h // 4), -(-w // 4), 1)))[:h, :w]
    return (rng.integers(0, 128, (h, w, 3)) + big).astype(np.uint8)


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


# --------------------------------------------------------------------------
# dense


DENSE_CASES = {  # name: (h, w, stride, batch, stripe_rows)
    "several_stripes": (320, 288, 32, 8, 96),
    "one_stripe": (256, 224, 32, 8, 1024),
    "exact_boundary": (64 + 160, 256, 32, 8, 160),  # h - ps == own
    "odd_sizes": (530, 415, 48, 8, 190),
}


def test_stripe_plan_matches_jax():
    for h, ps, stride, rows in [(224, 64, 32, 160), (530, 64, 48, 190), (64, 64, 32, 64),
                                (16384, 224, 112, 2048), (300, 64, 50, 10)]:
        assert _stripe_plan(h, ps, stride, rows) == jstream._stripe_plan(h, ps, stride, rows)
    own, n = _stripe_plan(64 + 160, 64, 32, 160)
    assert (own, n) == (160, 2)  # the last dense row y = h - ps gets its own stripe


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_streamed_dense_is_the_resident_predict_bit_for_bit(case, kind):
    h, w, stride, bs, rows = DENSE_CASES[case]
    img = _image(h, w)
    _, _, q, _, bf16 = narrow_int8()
    model = q if kind == "int8" else bf16
    kw = dict(patch_size=PS, stride=stride, batch_size=bs, downscale=D, device="cpu")
    want = predict_full_fused(img, model, NC, **kw)
    got = predict_full_streamed(img, model, NC, stripe_rows=rows, **kw)
    _same(got, want)
    assert got[0].dtype == np.uint8 and got[0].shape == (h // D, w // D)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_streamed_dense_matches_jax_streamed(case):
    h, w, stride, bs, rows = DENSE_CASES[case]
    img = _image(h, w)
    qm, qv, q, _, _ = narrow_int8()
    with jax.disable_jit():
        want_map, want_score = jstream.predict_full_streamed(
            img, qm, qv, NC, patch_size=PS, stride=stride, batch_size=bs, downscale=D,
            stripe_rows=rows)
    got_map, got_score = predict_full_streamed(img, q, NC, patch_size=PS, stride=stride,
                                               batch_size=bs, downscale=D, stripe_rows=rows,
                                               device="cpu")
    np.testing.assert_array_equal(got_map, np.asarray(want_map))
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), **DENSE_TOL)


def test_streamed_dense_prestage_all_reports_timings():
    h, w, stride, bs, rows = DENSE_CASES["several_stripes"]
    img = _image(h, w)
    q = narrow_int8()[2]
    t = {}
    got = predict_full_streamed(img, q, NC, patch_size=PS, stride=stride, batch_size=bs,
                                downscale=D, stripe_rows=rows, prestage_all=True, timings=t,
                                device="cpu")
    _same(got, predict_full_fused(img, q, NC, patch_size=PS, stride=stride, batch_size=bs,
                                  downscale=D, device="cpu"))
    assert t["staging_s"] > 0 and t["compute_s"] > 0


# --------------------------------------------------------------------------
# fcn


FCN_CASES = {  # name: (h, w, stripe_rows, tile_batch)
    "several_stripes": (192, 160, 64, 1),
    "one_stripe": (192, 160, 192, 4),
    "odd_sizes": (201, 147, 128, 3),
}


@pytest.mark.parametrize("case", FCN_CASES)
@pytest.mark.parametrize("kind", ["bf16", "int8 pack4", "int8 pack8"])
def test_streamed_fcn_is_the_resident_predict_bit_for_bit(case, kind):
    h, w, rows, tb = FCN_CASES[case]
    img = _image(h, w, seed=4)
    _, _, q, q8, bf16 = narrow_int8()
    model = {"bf16": bf16, "int8 pack4": q, "int8 pack8": q8}[kind]
    kw = dict(patch_size=PS, downscale=D, tile_batch=tb, device="cpu", **FCN)
    want = predict_full_fcn(img, model, NC, **kw)
    got = predict_full_fcn_streamed(img, model, NC, stripe_rows=rows, **kw)
    _same(got, want)
    assert got[0].dtype == np.uint8 and got[0].shape == (h // D, w // D)


@pytest.mark.parametrize("case", FCN_CASES)
@pytest.mark.parametrize("pack", [4, 8])
def test_streamed_fcn_matches_jax_streamed(pack, case):
    """pack 4: the unpacked int8 model on 4×4-packed stripes; pack 8: the
    pack_l1 model on 8×8-packed stripes (the JAX oracle runs its unpacked
    trunk on the 4×4 form, which it documents as pack_l1's bit for bit)."""
    h, w, rows, tb = FCN_CASES[case]
    img = _image(h, w, seed=4)
    qm, qv, q, q8, _ = narrow_int8()
    with jax.disable_jit():
        want_map, want_score = jstream.predict_full_fcn_streamed(
            img, qm, qv, NC, patch_size=PS, downscale=D, stripe_rows=rows, tile_batch=tb,
            **FCN)
    got_map, got_score = predict_full_fcn_streamed(
        img, q8 if pack == 8 else q, NC, patch_size=PS, downscale=D, stripe_rows=rows,
        tile_batch=tb, device="cpu", **FCN)
    np.testing.assert_array_equal(got_map, np.asarray(want_map))
    np.testing.assert_allclose(got_score.numpy(), np.asarray(want_score), **FCN_TOL)


def test_streamed_fcn_prestage_all_reports_timings():
    h, w, rows, tb = FCN_CASES["several_stripes"]
    img = _image(h, w, seed=4)
    q8 = narrow_int8()[3]
    t = {}
    kw = dict(patch_size=PS, downscale=D, tile_batch=tb, device="cpu", **FCN)
    got = predict_full_fcn_streamed(img, q8, NC, stripe_rows=rows, prestage_all=True,
                                    timings=t, **kw)
    _same(got, predict_full_fcn(img, q8, NC, **kw))
    assert t["staging_s"] > 0 and t["compute_s"] > 0


def test_streamed_predicts_refuse_what_the_jax_package_refuses():
    q = narrow_int8()[2]
    img = _image(64, 64)
    with pytest.raises(ValueError, match="smaller than patch_size"):
        predict_full_streamed(img[:32], q, NC, patch_size=PS, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        predict_full_fcn_streamed(img, q, NC, patch_size=PS, tile=48, halo=32, device="cpu")
    with pytest.raises(ValueError, match="window carry"):
        predict_full_fcn_streamed(_image(256, 256), q, NC, patch_size=224, tile=64, halo=32,
                                  stripe_rows=64, device="cpu")
    with pytest.raises(ValueError, match="n_classes"):
        predict_full_streamed(img, q, 256, patch_size=PS, device="cpu")
    if not torch.cuda.is_available():  # entry points run on the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict_full_streamed(img, q, NC, patch_size=PS)
