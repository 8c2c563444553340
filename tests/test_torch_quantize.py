"""The port's int8 PTQ (``deephisto_tpu_torch/models/quantize.py``) against
the JAX package's ``deephisto_tpu/models/quantize.py``: the same numpy
weights (full-width ResNet-18, every BN statistic random so that no block's
conv path is constant) and the same seeded inputs go through both.

* The int8 forward is held bit for bit on JAX's own ``qvariables`` carried
  across (``flax_qvariables_to_torch``): every int8 (and f32) tensor at every
  ``up_to`` boundary, both ``int8_residual`` settings, both stems, pack_l1
  and the packed inputs. The JAX oracle runs op by op (not jitted): a jitted
  XLA-CPU program contracts ``a·b + c`` into fused multiply-adds (its CPU
  compiler always allows FMA fusion), which moves an epilogue by an ulp and
  flips a requant; the source's op order, which the port and its kernel K6
  keep, rounds the product and the sum each on its own.
* The port's own ``quantize_resnet`` is held to stated tolerances: BN
  folding to 3.6e-7 relative (``lax.rsqrt`` on XLA-CPU and ``torch.rsqrt``
  are each within an ulp of the rounded root, so up to 2 ulps apart, and
  each side rounds its product once more), calibration absmax to 1e-5 relative
  (float convs summed in another order; measured <= 2e-6), scales to 1e-6
  relative beyond their absmax's difference, and int8 weights equal but for
  ±1 flips, each counted and each at a weight that JAX's own numbers put
  within 1e-4 of a rounding tie (the fold's ulp). From JAX's folded weights
  and absmax the port's quantization is JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import flax_and_torch_resnet

from deephisto_tpu.models import quantize as jq
from deephisto_tpu.predict.fcn import _host_pack_s2d as jax_host_pack
from deephisto_tpu_torch.models import QuantizedViT, ViT, quantize_model
from deephisto_tpu_torch.models import quantize as tq
from deephisto_tpu_torch.models.convert import flax_qvariables_to_torch
from deephisto_tpu_torch.models.patch_cls_simple import get_model
from deephisto_tpu_torch.ops import gather_quantize_int8

SIZE = 64  # input extent of the forward checks (full width, batch 2)
LOGITS_TOL = dict(rtol=0, atol=2e-6)  # the GAP mean summed in another order


def _calib():
    return [np.random.default_rng(0).random((2, SIZE, SIZE, 3)).astype(np.float32)]


def _u8(seed=7, n=2, size=SIZE):
    return (np.random.default_rng(seed).random((n, size, size, 3)) * 255).astype(np.uint8)


_CACHE = {}


def _pair(stem):
    """(flax module, JAX-shaped variables, port float model, JAX qvariables
    as numpy) for a full-width ResNet-18 with random BN, quantized by the
    JAX package on one calibration batch; made once per stem."""
    if stem not in _CACHE:
        jm, v, tm = flax_and_torch_resnet(18, stem=stem, num_filters=64, size=SIZE)
        jv = jax.tree.map(jnp.asarray, v)
        _, qv = jq.quantize_resnet(jm, jv, _calib())
        _CACHE[stem] = (jm, jv, tm, jax.tree.map(np.asarray, qv))
    return _CACHE[stem]


def _models(stem, int8_residual, pack_l1):
    jm, _, tm, qv = _pair(stem)
    jmodel = jq.QuantizedResNet(jm, int8_residual=int8_residual, pack_l1=pack_l1)
    tmodel = tq.QuantizedResNet(tm, flax_qvariables_to_torch(qv), int8_residual=int8_residual,
                                pack_l1=pack_l1)
    return jmodel, jax.tree.map(jnp.asarray, qv), tmodel


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, np.ndarray) else x


def _unpack_a(pa):
    """The JAX package's pack_A layout (B, h/2+1, w/2+1, 4c), channel
    (si·2 + sj)·c + ci holding row 2i-1+si and column 2j-1+sj → (B, h, w, c)."""
    b, hp, wp, c4 = pa.shape
    c = c4 // 4
    full = pa.reshape(b, hp, wp, 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return full.reshape(b, 2 * hp, 2 * wp, c)[:, 1:-1, 1:-1]


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_fold_conv_bn_matches_jax(stem):
    """Folded weights within 3.6e-7 relative (rsqrt 2 ulps apart, one
    rounding of the product on each side) and biases within 1e-6."""
    jm, jv, tm, _ = _pair(stem)
    want = jq._folded_params(jm, jv)
    got = tq._folded_params(tm)
    assert set(got) == set(want)
    for name, (w, b) in got.items():
        jw, jb = (np.asarray(a) for a in want[name])
        if name != "fc":
            w = w.permute(2, 3, 1, 0)  # OIHW → HWIO
        np.testing.assert_allclose(w.numpy(), jw, rtol=3.6e-7, atol=0, err_msg=name)
        np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_folded_float_apply_matches_jax_and_the_float_model(stem):
    """The folded float forward equals JAX's and the port's own unfolded
    float model to rtol=atol=1e-4 (float convs summed in other orders, as
    in test_torch_resnet.py): BN folding is exact to float rounding."""
    jm, jv, tm, _ = _pair(stem)
    x = _calib()[0]
    got = tq.folded_float_apply(tm, x).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.folded_float_apply(jm, jv, x)),
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_calibrate_matches_jax(stem):
    jm, jv, tm, _ = _pair(stem)
    want = jq.calibrate(jm, jv, _calib())
    got = tq.calibrate(tm, _calib())
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] / want[name] - 1) <= 1e-5, (name, got[name], want[name])


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_quantize_from_jax_fold_and_absmax_is_jax_bit_for_bit(stem):
    """Given JAX's folded weights and calibrated absmax, the port's scale
    arithmetic (s_x a Python float, dequant in f32, 1/s_x rounded to f32)
    gives JAX's qvariables bit for bit."""
    jm, jv, tm, qv = _pair(stem)
    folded = {}
    for name, (w, b) in jq._folded_params(jm, jv).items():
        w = torch.from_numpy(np.array(w))
        folded[name] = (w if name == "fc" else w.permute(3, 2, 0, 1), torch.from_numpy(np.array(b)))
    model = tq._quantize(tm, folded, jq.calibrate(jm, jv, _calib()))
    want = flax_qvariables_to_torch(qv)
    for name, p in want.items():
        if name == "fc":
            assert torch.equal(model.fc_kernel, p["kernel"]) and torch.equal(model.fc_bias, p["bias"])
            continue
        layer = model.q(name)
        for key, t in p.items():
            assert torch.equal(getattr(layer, key), t), (name, key)


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_quantize_resnet_matches_jax_with_counted_flips(stem):
    jm, jv, tm, qv = _pair(stem)
    model = tq.quantize_resnet(tm, _calib())
    absmax_j = jq.calibrate(jm, jv, _calib())
    absmax_t = tq.calibrate(tm, _calib())
    folded_j = jq._folded_params(jm, jv)
    flips = total = 0
    for name, p in qv["params"].items():
        if name == "fc":
            np.testing.assert_allclose(model.fc_kernel.numpy(), p["kernel"], rtol=0, atol=0)
            continue
        layer = model.q(name)
        a_ratio = absmax_t[name] / absmax_j[name]
        inv = float(layer.in_inv_scale) / float(p["in_inv_scale"])
        assert abs(inv * a_ratio - 1) <= 1e-6, (name, inv, a_ratio)
        deq = layer.dequant.numpy() / p["dequant"]
        assert np.abs(deq / a_ratio - 1).max() <= 1e-6, name
        got = layer.kernel_q.permute(1, 2, 3, 0).numpy()
        diff = got.astype(np.int32) - p["kernel_q"]
        assert np.abs(diff).max() <= 1, name
        if diff.any():
            w = np.asarray(folded_j[name][0])
            s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / np.float32(127.0)
            r = w / s_w
            tie = np.abs(np.abs(r - np.floor(r)) - 0.5)
            assert tie[diff != 0].max() <= 1e-4, (name, tie[diff != 0].max())
        flips += int((diff != 0).sum())
        total += diff.size
    assert flips <= 1e-4 * total, (flips, total)


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
@pytest.mark.parametrize("int8_residual", [False, True])
@pytest.mark.parametrize("pack_l1", [False, True])
def test_int8_forward_is_jax_bit_for_bit_at_every_boundary(stem, int8_residual, pack_l1):
    """On JAX's qvariables: every boundary tensor equal (JAX's pack_l1 "l1"
    is its pack_A layout: unpacked here, and compared with the port's
    stage-1 output carried as JAX carries it), the features equal in bf16,
    the logits within 2e-6."""
    jmodel, qv, tmodel = _models(stem, int8_residual, pack_l1)
    u8 = _u8()
    x = torch.from_numpy(u8)
    bounds = ["quant", "layer2", "layer3", "layer4"]
    bounds += ["l2_entry"] if pack_l1 else ["stem", "l1"]
    for b in bounds:
        want = _np(jmodel.apply(qv, jnp.asarray(u8), up_to=b))
        got = tmodel(x, up_to=b).float().numpy()
        np.testing.assert_array_equal(got, want, err_msg=b)
    if pack_l1:
        want = _unpack_a(_np(jmodel.apply(qv, jnp.asarray(u8), up_to="l1")))
        l1 = tmodel(x, up_to="l1")
        l1 = (tmodel._quant_to("layer2_0/conv1", l1) if int8_residual else l1.to(torch.bfloat16))
        np.testing.assert_array_equal(l1.float().numpy(), want)
    np.testing.assert_array_equal(
        tmodel(x, features=True).float().numpy(), _np(jmodel.apply(qv, jnp.asarray(u8), features=True)))
    logits = tmodel(x).numpy()
    np.testing.assert_allclose(logits, np.asarray(jmodel.apply(qv, jnp.asarray(u8))), **LOGITS_TOL)
    # the predicts' route: K1's int8 mode quantizes the windows through the
    # model's table and lays them out for its stem; the same logits
    one_each = (torch.arange(len(u8), dtype=torch.int32), torch.zeros((len(u8), 2), dtype=torch.int32))
    layout, pre_packed = tmodel.input_layout(False)
    x8 = gather_quantize_int8(x, *one_each, SIZE, tmodel.input_lut, layout)
    assert np.array_equal(tmodel(x8, pre_packed=pre_packed).numpy(), logits)
    if stem == "s2d":  # packed inputs: the same logits, bit for bit
        p4 = np.stack([jax_host_pack(im, pack=4) for im in u8])
        assert np.array_equal(tmodel(torch.from_numpy(p4), pre_packed=True).numpy(), logits)
        if pack_l1:
            p8 = np.stack([jax_host_pack(im, pack=8) for im in u8])
            assert np.array_equal(tmodel(torch.from_numpy(p8), pre_packed="s2d8").numpy(), logits)
            layout, pre_packed = tmodel.input_layout("s2d8")
            x8 = gather_quantize_int8(torch.from_numpy(p8), *one_each, SIZE // 8, tmodel.input_lut,
                                      layout)
            assert np.array_equal(tmodel(x8, pre_packed=pre_packed).numpy(), logits)
            np.testing.assert_allclose(
                logits, np.asarray(jmodel.apply(qv, jnp.asarray(p8), pre_packed="s2d8")),
                **LOGITS_TOL)


def test_prequantize_input_matches_jax_and_commutes_with_the_model():
    """``prequantize_input`` is JAX's bit for bit on a uint8 slide and on a
    float one, and the int8 input gives the logits of the uint8 one."""
    jmodel, qv, tmodel = _models("s2d", False, False)
    slide = _u8(seed=3, n=1, size=96)[0]
    got = tq.prequantize_input(tmodel, slide)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.prequantize_input(qv, slide)))
    xf = slide.astype(np.float32) / 255.0
    np.testing.assert_array_equal(tq.prequantize_input(tmodel, xf).numpy(),
                                  np.asarray(jq.prequantize_input(qv, xf)))
    crop = torch.from_numpy(slide[None, :SIZE, 16 : 16 + SIZE].copy())
    assert torch.equal(tmodel(got[None, :SIZE, 16 : 16 + SIZE].contiguous()), tmodel(crop))


def test_the_int8_model_shares_no_storage_with_the_float_model():
    """The folded fc head is a view of the float model's parameters; the
    int8 model copies it, so a later change of the float model (centring
    its head, a training step) leaves the int8 model as it was."""
    tm = get_model(5, depth=18, stem="s2d", dtype=torch.float32).eval()
    model = tq.quantize_resnet(tm, _calib())
    x = torch.from_numpy(_u8())
    before = model(x)
    with torch.no_grad():
        tm.fc.bias += 1.0
        tm.fc.weight.mul_(2.0)
    assert torch.equal(model(x), before)


def test_quantize_model_dispatches_the_resnet_and_refuses_the_vit():
    """``quantize_model`` sends a ResNet to ``quantize_resnet`` and, since the
    ViT's W8A8 PTQ is ported (``models/quantize_vit.py``), a ViT to
    ``quantize_vit``: it no longer refuses the ViT."""
    tm = _pair("s2d")[2]
    model = quantize_model(tm, _calib())
    assert isinstance(model, tq.QuantizedResNet) and model.wants_uint8
    vit = ViT(5, depth=1, dim=64, heads=2, dtype=torch.float32, img_size=SIZE)
    qvit = quantize_model(vit, _calib())
    assert isinstance(qvit, QuantizedViT) and qvit.wants_uint8


def test_packed_options_are_refused_where_the_jax_package_refuses_them():
    tm = _pair("s2d")[2]
    qv = flax_qvariables_to_torch(_pair("s2d")[3])
    with pytest.raises(ValueError, match="pack_l1 requires"):
        tq.QuantizedResNet(get_model(5, depth=50, stem="s2d"), {"fc": qv["fc"]}, pack_l1=True)
    with pytest.raises(ValueError, match="requires pack_l1"):
        tq.QuantizedResNet(tm, qv)(torch.zeros((1, 8, 8, 192), dtype=torch.uint8),
                                   pre_packed="s2d8")
    with pytest.raises(ValueError, match="even stage-1"):
        tq.QuantizedResNet(tm, qv, pack_l1=True)(torch.zeros((1, 36, 36, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="up_to"):
        tq.QuantizedResNet(tm, qv)(torch.zeros((1, 32, 32, 3), dtype=torch.uint8), up_to="pack")
