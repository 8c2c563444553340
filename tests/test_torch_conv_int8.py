"""K6's block mode (``deephisto_tpu_torch/ops/conv_int8.py:conv_int8_block``)
and the int8 forward that runs on it, on the CPU, where the wrappers take
their plain versions.

* The block mode's plain version equals the unfused composition bit for
  bit: ``conv_f32``, then the block epilogue as separate torch ops in the
  JAX package's order (quantize.py:669-684: residual, add, relu, bf16
  carry, requant), for every residual kind and output, at odd channel
  counts and stride 2.
* Its epilogue equals numpy's f32 arithmetic step by step (a product, then
  a sum, never a fused multiply-add; bf16 rounding to nearest even;
  rint half to even; the clip).
* The design chooser maps ResNet-18's convs to the designs the kernel has.
* ``QuantizedResNet.forward`` on the fused calls equals the same forward
  through the unfused composition, bit for bit, at every ``up_to``
  boundary, both stems and both ``int8_residual`` settings. (Its agreement
  with the JAX package is held in ``test_torch_quantize.py`` and
  ``test_torch_fcn.py``.)

bf16 carries are compared by value (``torch.equal``): relu may give -0 where
the other side gives +0, which is the same value and the same int8.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deephisto_tpu_torch.models import quantize as tq
from deephisto_tpu_torch.models.patch_cls_simple import get_model
from deephisto_tpu_torch.ops import conv_int8 as k6

# (x shape NHWC, Cout, kernel, stride, pads): odd channel counts, stride 2
# with SAME's uneven (0, 1) pads, the wgmma design's Cin 64
BLOCK_CASES = [
    ((2, 9, 11, 20), 5, 3, 1, ((1, 1), (1, 1))),
    ((2, 10, 12, 64), 24, 3, 2, ((0, 1), (0, 1))),
    ((1, 7, 9, 48), 19, 2, 1, ((0, 1), (0, 1))),
]
RES = ("none", "bf16", "f32", "int8")
OUTS = ("carry", "int8", "f32")


def _conv_inputs(shape, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, shape, dtype=np.int8)
    w = rng.integers(-127, 128, (cout, k, k, shape[3]), dtype=np.int8)
    a = (rng.uniform(0.5, 2.0, cout) * 1e-4).astype(np.float32)
    b = rng.normal(0, 1.0, cout).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, w, a, b)]


def _epilogue_inputs(out_shape, res_kind, seed):
    """A residual of ``res_kind`` and the scalars, from numpy."""
    rng = np.random.default_rng(seed)
    res_scale = torch.tensor(np.float32(rng.uniform(0.01, 0.05)))
    next_inv = torch.tensor(np.float32(rng.uniform(3.0, 9.0)))
    if res_kind == "none":
        return None, res_scale, next_inv
    if res_kind == "int8":
        return torch.from_numpy(rng.integers(-127, 128, out_shape, dtype=np.int8)), res_scale, \
            next_inv
    r = torch.from_numpy(rng.normal(0, 2.0, out_shape).astype(np.float32))
    return (r.to(torch.bfloat16) if res_kind == "bf16" else r), res_scale, next_inv


def _out_shape(shape, cout, k, stride, pads):
    oh = k6.out_extent(shape[1], k, stride, pads[0])
    ow = k6.out_extent(shape[2], k, stride, pads[1])
    return (shape[0], oh, ow, cout)


def _unfused(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv, out):
    """``conv_f32``, then the block epilogue as separate torch ops."""
    y_f = k6.conv_f32(x, w, stride, pads, a, b)
    if res_kind == "none":
        out_f = torch.relu(y_f)
    else:
        if res_kind == "int8":
            res_f = residual.float() * res_scale
        elif res_kind == "bf16":
            res_f = residual.float()
        else:
            res_f = residual
        out_f = torch.relu(y_f + res_f)
    if out == "f32":
        return out_f

    def requant(t):
        return torch.clamp(torch.round(t.float() * next_inv), -127, 127).to(torch.int8)

    if out == "int8":
        return requant(out_f)
    x_bf = out_f.to(torch.bfloat16)
    return x_bf, requant(x_bf)


def _same(got, want):
    if isinstance(want, tuple):
        return len(got) == 2 and all(_same(g, v) for g, v in zip(got, want))
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("res_kind", RES)
@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_block_mode_is_the_unfused_composition(case, res_kind, out):
    shape, cout, k, stride, pads = BLOCK_CASES[case]
    x, w, a, b = _conv_inputs(shape, cout, k, seed=case)
    residual, res_scale, next_inv = _epilogue_inputs(
        _out_shape(shape, cout, k, stride, pads), res_kind, seed=10 + case)
    args = (x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv, out)
    got = k6.conv_int8_block(*args)
    assert _same(got, _unfused(*args))
    assert _same(k6.conv_int8_block_ref(*args), got)


def _bf16_rn(f):
    """f32 → bf16 → f32, round to nearest even, in numpy integer arithmetic."""
    u = f.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("res_kind", RES)
def test_block_epilogue_is_numpy_f32_step_by_step(res_kind, out):
    shape, cout, k, stride, pads = BLOCK_CASES[1]
    x, w, a, b = _conv_inputs(shape, cout, k, seed=3)
    residual, res_scale, next_inv = _epilogue_inputs(
        _out_shape(shape, cout, k, stride, pads), res_kind, seed=4)
    acc = k6.conv_s32_ref(x, w, stride, pads).numpy()
    y = np.multiply(acc.astype(np.float32), a.numpy(), dtype=np.float32) + b.numpy()
    if res_kind != "none":
        if res_kind == "int8":
            r = np.multiply(residual.numpy().astype(np.float32), res_scale.numpy(),
                            dtype=np.float32)
        else:
            r = residual.float().numpy()
        y = np.add(y, r, dtype=np.float32)
    o = np.maximum(y, np.float32(0))
    got = k6.conv_int8_block(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                             out)
    inv = next_inv.numpy()

    def q8(v):
        return np.clip(np.rint(np.multiply(v, inv, dtype=np.float32)), -127, 127).astype(np.int8)

    if out == "f32":
        np.testing.assert_array_equal(got.numpy(), o)
    elif out == "int8":
        np.testing.assert_array_equal(got.numpy(), q8(o))
    else:
        carry = _bf16_rn(o)
        np.testing.assert_array_equal(got[0].float().numpy(), carry)
        np.testing.assert_array_equal(got[1].numpy(), q8(carry))


def test_block_mode_refuses_what_it_does_not_take():
    shape, cout, k, stride, pads = BLOCK_CASES[0]
    x, w, a, b = _conv_inputs(shape, cout, k, seed=0)
    oshape = _out_shape(shape, cout, k, stride, pads)
    r16 = torch.zeros(oshape, dtype=torch.bfloat16)
    inv = torch.tensor(2.0)
    with pytest.raises(ValueError, match="res_kind"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16, "fp16", None, inv, "carry")
    with pytest.raises(ValueError, match="out must be"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16, "bf16", None, inv, "bf16")
    with pytest.raises(ValueError, match="residual must be"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16.float(), "bf16", None, inv, "carry")
    with pytest.raises(ValueError, match="residual must be"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16[:1], "bf16", None, inv, "carry")
    with pytest.raises(ValueError, match="takes no residual"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16, "none", None, inv, "carry")
    with pytest.raises(ValueError, match="next_inv"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16, "bf16", None, None, "int8")
    with pytest.raises(ValueError, match="res_scale"):
        k6.conv_int8_block(x, w, stride, pads, a, b, r16.to(torch.int8), "int8", 0.5, inv, "f32")


@pytest.mark.parametrize("stem", ["s2d", "imagenet"])
def test_design_of_each_resnet18_conv(stem):
    """The stems (Cin 48 after the s2d pack, 3 for the imagenet stem) take
    the mma.sync kernel; every block conv and downsample (Cin 64-512) the
    wgmma one."""
    model = get_model(5, depth=18, stem=stem, dtype=torch.float32)
    cins = {name: m.in_channels for name, m in model.named_modules()
            if isinstance(m, torch.nn.Conv2d)}
    assert cins["conv1"] == (48 if stem == "s2d" else 3)
    for name, cin in cins.items():
        want = "mma.sync" if name == "conv1" else "wgmma"
        assert k6.conv_design(cin) == want, name
    assert {c for n, c in cins.items() if n != "conv1"} == {64, 128, 256, 512}


def test_design_codes_are_the_kernels_enums():
    """The codes the wrapper passes are those of csrc/conv_int8.cu's enums,
    and the kernel's entry point refuses any other (its checks are read
    from the source here; tests/test_torch_kernels.py calls it on the card)."""
    src = (Path(k6.__file__).parents[1] / "csrc" / "conv_int8.cu").read_text()

    def enum(name):
        body = re.search(rf"enum {name} : int \{{([^}}]*)\}}", src).group(1)
        return dict((n, int(c)) for n, c in re.findall(r"k(\w+) = (\d+)", body))

    assert enum("Design") == {"MmaSync": k6.DESIGNS["mma.sync"], "Wgmma": k6.DESIGNS["wgmma"]}
    assert enum("Mode") == {"ModeF32": 0, "ModeInt8": 1, "ModeBlock": 2} and \
        list(k6.MODES.values()) == [0, 1, 2]
    assert enum("Res") == {f"Res{k.capitalize()}": v for k, v in k6.RES_KINDS.items()}
    assert enum("Out") == {f"Out{k.capitalize()}": v for k, v in k6.OUT_KINDS.items()}
    with pytest.raises(ValueError, match="Cin"):
        k6.conv_design(0)


# ---------------------------------------------------------------------------
# the int8 forward on the fused calls vs the unfused composition
# ---------------------------------------------------------------------------

SIZE = 64
_MODELS = {}


def _qmodel(stem, int8_residual, depth=18):
    """A full-width ResNet (random BN statistics) quantized by the port on
    one seeded batch; made once per (stem, depth)."""
    key = (stem, depth)
    if key not in _MODELS:
        torch.manual_seed(0)
        model = get_model(5, depth=depth, stem=stem, dtype=torch.float32).eval()
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    n = m.num_features
                    m.running_mean.copy_(torch.randn(n, generator=gen) * 0.2)
                    m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                    m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                    m.bias.copy_(torch.randn(n, generator=gen) * 0.2)
        calib = [np.random.default_rng(2).random((1, SIZE, SIZE, 3)).astype(np.float32)]
        _MODELS[key] = (model, tq.quantize_resnet(model, calib))
    model, q = _MODELS[key]
    return tq.QuantizedResNet(model, {**{n: _qparams(q, n) for n in tq._conv_names(model)},
                                      "fc": {"kernel": q.fc_kernel, "bias": q.fc_bias}},
                              int8_residual=int8_residual)


def _qparams(q, name):
    c = q.q(name)
    return {"kernel_q": c.kernel_q, "dequant": c.dequant, "bias": c.bias,
            "in_inv_scale": c.in_inv_scale}


@torch.no_grad()
def _unfused_forward(m, x, features=False, up_to=None):
    """The int8 forward on K6's f32 and int8 modes alone, with the requant
    constants formed per call and the block epilogue as torch ops, in the
    JAX package's order (quantize.py:520-684)."""
    def conv_f32(name, x8, stride, padding=None):
        c = m.q(name)
        return k6.conv_f32(x8, c.kernel_q, stride, padding or tq._same(x8, c.kernel_q.shape[1],
                                                                        stride), c.dequant, c.bias)

    def conv_to_int8(name, nxt, x8, stride, padding=None):
        c, inv = m.q(name), m.q(nxt).in_inv_scale
        return k6.conv_to_int8(x8, c.kernel_q, stride,
                               padding or tq._same(x8, c.kernel_q.shape[1], stride),
                               c.dequant * inv, c.bias * inv)

    def quant_to(name, xf):
        inv = m.q(name).in_inv_scale
        return torch.clamp(torch.round(xf.float() * inv), -127, 127).to(torch.int8)

    blocks = m._block_list
    x8 = m.quantize_input(x)
    if up_to == "quant":
        return x8
    first = f"{blocks[0][0]}/conv1"
    x_bf = None
    if m.stem == "s2d":
        x8 = tq.s2d_pack4(x8).contiguous()
        stride, pad = 1, None
    else:
        stride, pad = 2, ((3, 3), (3, 3))
    if m.int8_residual:
        x8 = conv_to_int8("conv1", first, x8, stride, pad)
        if m.stem != "s2d":
            x8 = tq.max_pool(x8)
    else:
        x_f = torch.relu(conv_f32("conv1", x8, stride, pad))
        if m.stem != "s2d":
            x_f = tq.max_pool(x_f)
        x_bf = x_f.to(torch.bfloat16)
        x8 = quant_to(first, x_bf)
    if up_to == "stem":
        return x8 if x_bf is None else x_bf
    n1 = m.stage_sizes[0]
    for bi, (name, stride) in enumerate(blocks):
        if m.basic:
            h8 = conv_to_int8(f"{name}/conv1", f"{name}/conv2", x8, stride)
            y_f = conv_f32(f"{name}/conv2", h8, 1)
        else:
            h8 = conv_to_int8(f"{name}/conv1", f"{name}/conv2", x8, 1)
            h8 = conv_to_int8(f"{name}/conv2", f"{name}/conv3", h8, stride)
            y_f = conv_f32(f"{name}/conv3", h8, 1)
        if f"{name}__downsample_conv" in m.convs:
            res_f = conv_f32(f"{name}/downsample_conv", x8, stride)
        elif m.int8_residual:
            res_f = x8.float() * (1.0 / m.q(f"{name}/conv1").in_inv_scale)
        else:
            res_f = x_bf.float()
        out_f = torch.relu(y_f + res_f)
        if not m.int8_residual:
            x_bf = out_f.to(torch.bfloat16)
        if bi + 1 < len(blocks):
            x8 = quant_to(f"{blocks[bi + 1][0]}/conv1", out_f if m.int8_residual else x_bf)
        stage = name.split("_")[0]
        stage_done = bi + 1 == len(blocks) or not blocks[bi + 1][0].startswith(stage + "_")
        if stage_done and up_to == {"layer1": "l1"}.get(stage, stage):
            return out_f
        if bi == n1 and up_to == "l2_entry":
            return out_f
    if features:
        return out_f.to(torch.bfloat16)
    return out_f.mean(dim=(1, 2)) @ m.fc_kernel + m.fc_bias


@pytest.mark.parametrize("int8_residual", [False, True])
@pytest.mark.parametrize("stem,depth", [("s2d", 18), ("imagenet", 18), ("s2d", 50)])
def test_int8_forward_on_the_block_mode_is_the_unfused_forward(stem, depth, int8_residual):
    m = _qmodel(stem, int8_residual, depth)
    x = torch.from_numpy((np.random.default_rng(5).random((1, SIZE, SIZE, 3)) * 255)
                         .astype(np.uint8))
    for up_to in tq.UP_TO:
        got, want = m(x, up_to=up_to), _unfused_forward(m, x, up_to=up_to)
        assert got.dtype == want.dtype and torch.equal(got, want), up_to
    assert torch.equal(m(x, features=True), _unfused_forward(m, x, features=True))
    logits = m(x)
    assert torch.equal(logits, _unfused_forward(m, x))
    assert len(torch.unique(logits)) > 1
