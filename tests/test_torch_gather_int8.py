"""K1's int8 mode (``ops/gather.py:gather_quantize_int8``) against the JAX
package: the int8 model's input table against the JAX package's input
quantize (``deephisto_tpu/models/quantize.py:493-496``) for all 256 bytes,
and the plain version in each layout against the JAX package's gather
(``gather_patches_multi_xla``), quantize and s2d packs, bit for bit, with
clamped and negative starts. The quantized batches it hands the int8 ResNet
give the logits of the uint8 batches. The kernel's cut of the paths'
windows (``int8_plan``, as ``csrc/gather.cu`` plans it) fits a block, and a
bank takes 2-D TMA boxes only where its rows are 16-byte aligned. The
kernel itself runs only on a card (test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.ops.gather import gather_patches_multi_xla
from deephisto_tpu.predict.fcn import _host_pack_s2d as jax_host_pack
from deephisto_tpu.predict.fcn import s2d_pack_image as jax_s2d_pack
from deephisto_tpu_torch import _build
from deephisto_tpu_torch.models import ResNet18
from deephisto_tpu_torch.models import quantize as tq
from deephisto_tpu_torch.ops.gather import int8_launch_plan, int8_plan
from deephisto_tpu_torch.ops import (
    gather_patches_multi,
    gather_quantize_int8,
    gather_quantize_int8_ref,
)

_CACHE = {}


def _tiny(stem):
    """A narrow ResNet-18 (width 8) and its calibrated int8 model."""
    if stem not in _CACHE:
        torch.manual_seed(0)
        tm = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32, stem=stem).eval()
        calib = [np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)]
        _CACHE[stem] = tm, tq.quantize_resnet(tm, calib), calib
    return _CACHE[stem]


def _jax_quantize(u8, inv0):
    """The JAX package's uint8 input quantize at conv1's input scale inv0."""
    x = jnp.asarray(u8).astype(jnp.float32) * (jnp.asarray(inv0, jnp.float32) / 255.0)
    return np.asarray(jnp.clip(jnp.round(x), -127, 127).astype(jnp.int8))


def _lut(inv0):
    return torch.from_numpy(_jax_quantize(np.arange(256, dtype=np.uint8), inv0))


def _bank(s, h, w, c, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (s, h, w, c), dtype=np.uint8)


def _starts(h, w, ps, n=10, seed=1):
    """(slide_idx, coords): in range, clamped past each edge, negative
    (counted from the end) and far off."""
    rng = np.random.default_rng(seed)
    fixed = [(0, 0), (h - ps, w - ps), (-1, 3), (2, -ps), (h, w), (-h - 5, 1), (5000, -5000)]
    rand = rng.integers(-h, h + 4, size=(n, 2))
    coords = np.concatenate([fixed, rand]).astype(np.int32)
    sidx = rng.integers(-3, 4, len(coords)).astype(np.int32)
    return sidx, coords


@pytest.mark.parametrize("case", ["calibrated", "tie"])
def test_input_lut_is_the_jax_input_quantize_for_all_256_bytes(case):
    tm, model, calib = _tiny("s2d")
    if case == "tie":  # inv0 = 127.5: u·inv0/255 = u/2 lands on .5 for every odd u
        absmax = {**tq.calibrate(tm, calib), "conv1": 254 / 255}
        model = tq._quantize(tm, tq._folded_params(tm), absmax)
        assert float(model.q("conv1").in_inv_scale) == 127.5
    inv0 = model.q("conv1").in_inv_scale.numpy()
    u = np.arange(256, dtype=np.uint8)
    frac = (u.astype(np.float32) * (inv0 / np.float32(255.0))) % 1
    assert (case == "tie") == bool((frac == 0.5).any())
    assert model.input_lut.dtype == torch.int8 and model.input_lut.shape == (256,)
    np.testing.assert_array_equal(model.input_lut.numpy(), _jax_quantize(u, inv0))
    assert torch.equal(model.input_lut, model.quantize_input(torch.from_numpy(u)))


@pytest.mark.parametrize("layout,channels,ps", [("hwc", 3, 12), ("hwc", 48, 7), ("s2d4", 3, 16)])
def test_plain_layouts_match_jax_gather_quantize_and_pack(layout, channels, ps):
    bank = _bank(3, 40, 52, channels)
    sidx, coords = _starts(40, 52, ps)
    inv0 = np.float32(127.0 / 0.93)
    got = gather_quantize_int8(torch.from_numpy(bank), sidx, coords, ps, _lut(inv0), layout)
    want = _jax_quantize(
        gather_patches_multi_xla(jnp.asarray(bank), jnp.asarray(sidx), jnp.asarray(coords), ps),
        inv0)
    if layout == "s2d4":
        want = np.stack([np.asarray(jax_s2d_pack(jnp.asarray(w))) for w in want])
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_s2d8_to_s2d4_is_the_4x4_pack_of_the_same_pixels():
    """An "s2d8" staging (the fcn's pack-8 form of the slide) gathered in
    8-pixel cells and laid out 4×4 equals the JAX package's 4×4 pack of the
    raw window at the same place, quantized; starts in cells clamp as the
    raw starts clamp."""
    raw = _bank(2, 64, 80, 3, seed=3)
    s2d8 = np.stack([jax_host_pack(im, 8) for im in raw])  # (2, 8, 10, 192)
    t = 3
    sidx, coords = _starts(8, 10, t, seed=4)
    inv0 = np.float32(120.25)
    got = gather_quantize_int8(torch.from_numpy(s2d8), sidx, coords, t, _lut(inv0),
                               "s2d8_to_s2d4")
    assert got.shape == (len(coords), 2 * t, 2 * t, 48)
    windows = gather_patches_multi_xla(jnp.asarray(raw), jnp.asarray(sidx),
                                       jnp.asarray(8 * coords), 8 * t)
    want = np.stack([np.asarray(jax_s2d_pack(jnp.asarray(w))) for w in _jax_quantize(windows, inv0)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stem,packed", [("s2d", False), ("s2d", True), ("s2d", "s2d8"),
                                         ("imagenet", False)])
def test_the_int8_route_gives_the_uint8_logits(stem, packed):
    """What the predicts hand the int8 ResNet (K1's int8 mode in the layout
    ``input_layout`` names, with its ``pre_packed``) gives the logits of
    the raw uint8 windows bit for bit."""
    _, model, _ = _tiny(stem)
    raw = _bank(1, 96, 96, 3, seed=5)
    sidx, coords = np.zeros(3, np.int32), np.array([[0, 0], [32, 64], [-8, 40]], np.int32)
    want = model(gather_patches_multi(torch.from_numpy(raw), sidx, coords, 32))
    unit = {False: 1, True: 4, "s2d8": 8}[packed]
    bank = raw if unit == 1 else np.stack([jax_host_pack(raw[0], unit)])
    if packed == "s2d8":
        model.pack_l1 = True  # the port's pack_l1 is math: the same trunk
    layout, pre_packed = model.input_layout(packed)
    x8 = gather_quantize_int8(torch.from_numpy(bank), sidx, coords // unit, 32 // unit,
                              model.input_lut, layout)
    model.pack_l1 = False
    assert x8.dtype == torch.int8
    assert torch.equal(model(x8, pre_packed=pre_packed), want)


def test_input_layout_by_stem_and_staging():
    s2d, imagenet = _tiny("s2d")[1], _tiny("imagenet")[1]
    assert s2d.input_layout(False) == ("s2d4", True)
    assert s2d.input_layout(True) == ("hwc", True)
    assert s2d.input_layout("s2d8") == ("s2d8_to_s2d4", True)
    assert imagenet.input_layout(False) == ("hwc", False)
    with pytest.raises(ValueError, match="s2d stem"):
        imagenet.input_layout(True)


def test_gather_quantize_int8_refuses_what_the_kernel_does_not_take():
    bank = torch.from_numpy(_bank(1, 32, 32, 3))
    ok = (torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32))
    lut = torch.zeros(256, dtype=torch.int8)
    with pytest.raises(ValueError, match="layout"):
        gather_quantize_int8(bank, *ok, 8, lut, "s2d8")
    with pytest.raises(ValueError, match="192-channel"):
        gather_quantize_int8(bank, *ok, 8, lut, "s2d8_to_s2d4")
    with pytest.raises(ValueError, match="% 4"):
        gather_quantize_int8(bank, *ok, 10, lut, "s2d4")
    for bad in (lut.to(torch.uint8), lut[:255], lut.float(), np.zeros(256, np.int8)):
        with pytest.raises(ValueError, match="lut"):
            gather_quantize_int8(bank, *ok, 8, bad, "hwc")
    with pytest.raises(ValueError, match="uint8"):
        gather_quantize_int8(bank.float(), *ok, 8, lut, "hwc")
    with pytest.raises(ValueError, match="int32"):
        gather_quantize_int8(bank, ok[0].long(), ok[1], 8, lut, "hwc")
    with pytest.raises(ValueError, match="does not fit"):
        gather_quantize_int8(bank, *ok, 33, lut, "hwc")
    wide = torch.zeros((1, 64, 64, 920), dtype=torch.uint8)  # 4 rows of 58,880 bytes
    with pytest.raises(ValueError, match="does not fit K1"):
        gather_quantize_int8(wide, *ok, 64, lut, "s2d4")


def test_cpu_banks_take_the_plain_version():
    _build.reset_launches()
    bank = torch.from_numpy(_bank(2, 32, 32, 3))
    sidx, coords = _starts(32, 32, 8)
    lut = _lut(np.float32(100.0))
    got = gather_quantize_int8(bank, sidx, coords, 8, lut, "s2d4")
    assert torch.equal(got, gather_quantize_int8_ref(bank, sidx, coords, 8, lut, "s2d4"))
    assert _build.launches.get("gather_quantize_int8", 0) == 0


# the int8 paths' calls: (layout, window, channels) of the exact batch, the
# int8 ViT, the fcn headline and pack-4 steps, a PackedSlide batch and the
# CLI's fcn tiles
PLAN_CASES = [("s2d4", 224, 3), ("hwc", 224, 3), ("s2d8_to_s2d4", 144, 192), ("hwc", 288, 48),
              ("hwc", 56, 48), ("hwc", 1152, 3)]


@pytest.mark.parametrize("layout,ps,channels", PLAN_CASES)
def test_int8_plan_cuts_fit_a_block(layout, ps, channels):
    """Both of K1's int8 cuts of the paths' windows fit a Hopper block: a
    part's row with its up to 15 leading bytes fits its staged row, a box's
    row its 2 KB, an item's rows the producer warp's lanes, the parts cover
    the group's units, the ring and table 227 KB."""
    units = {"s2d4": ps // 4, "hwc": -(-ps * channels // 16), "s2d8_to_s2d4": ps}[layout]
    unit = {"s2d4": 4 * channels, "hwc": 16, "s2d8_to_s2d4": channels}[layout]
    for box in (True, False):
        plan = int8_plan(layout, ps, channels, box=box)
        assert 0 < plan["smem"] <= 227 * 1024
        assert plan["per_part"] * unit + 15 <= plan["row_pitch"] and plan["row_pitch"] % 16 == 0
        assert plan["parts"] * plan["per_part"] >= units > (plan["parts"] - 1) * plan["per_part"]
        assert plan["per_item"] * plan["rows"] <= 32 and plan["stages"] % 16 == 0
        if box:
            assert plan["row_pitch"] <= 2048


def test_int8_launch_plan_takes_a_box_only_for_aligned_rows():
    """The kernel copies a bank's rows as 2-D TMA boxes only where its rows
    and base are 16-byte aligned; otherwise one bulk copy a row."""
    aligned = torch.zeros((1, 300, 320, 3), dtype=torch.uint8)  # rows of 960 bytes
    assert int8_launch_plan(aligned, "s2d4", 224)["box"]
    assert not int8_launch_plan(torch.zeros((1, 300, 301, 3), dtype=torch.uint8), "s2d4", 224)["box"]
    shifted = torch.zeros(300 * 320 * 3 + 1, dtype=torch.uint8)[1:].view(1, 300, 320, 3)
    assert not int8_launch_plan(shifted, "hwc", 224)["box"]
