"""Kernel K8 (``ops/layernorm.py``: a residual add, with LayerScale, and the
LayerNorm after it) on the CPU: its plain versions against today's ops, the
wrapper's refusals, and the ViTs' grad-off chain through it against the
block loop, bit for bit. The kernel itself runs on the card only
(``tests/test_torch_kernels.py``). This file imports no JAX."""

import importlib
from functools import partial

import pytest
import torch

from deephisto_tpu_torch import _build
from deephisto_tpu_torch.models import vit as vit_module
from deephisto_tpu_torch.models.vit import RegViT, ViT, _LayerNorm, fold_vit_stem
from deephisto_tpu_torch.ops import add_layernorm, add_layernorm_ref, layernorm, layernorm_ref

# the module: ``ops.layernorm`` names its function
k8 = importlib.import_module("deephisto_tpu_torch.ops.layernorm")
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(dtype, rows=37, dim=48, seed=0, gamma=False):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, dim, generator=g) * 2 + 0.5).to(dtype)
    r = torch.randn(rows, dim, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(dim, generator=g)
    b = 0.02 * torch.randn(dim, generator=g)
    ls = (0.5 + 0.1 * torch.randn(dim, generator=g)).to(dtype) if gamma else None
    return x, r, w, b, ls


def _module_norm(w, b):
    norm = _LayerNorm(w.shape[0])
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    return norm


@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_layernorm_ref_is_the_add_then_the_models_layernorm(dtype, gamma):
    x, r, w, b, ls = _inputs(dtype, gamma=gamma)
    s, y = add_layernorm_ref(x, r, w, b, 1e-6, ls)
    want_s = x + r if ls is None else torch.addcmul(x, ls, r)
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, want_s)
    with torch.no_grad():
        assert torch.equal(y, _module_norm(w, b)(want_s))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_ref_is_the_models_layernorm(dtype):
    x, _, w, b, _ = _inputs(dtype, rows=5, dim=64, seed=1)
    x = x.reshape(5, 1, 64).expand(5, 3, 64).contiguous()
    with torch.no_grad():
        assert torch.equal(layernorm_ref(x, w, b, 1e-6), _module_norm(w, b)(x))


@pytest.mark.parametrize("gamma", [False, True])
def test_cpu_tensors_take_the_plain_versions(gamma):
    x, r, w, b, ls = _inputs(torch.bfloat16, gamma=gamma, seed=2)
    _build.reset_launches()
    s, y = add_layernorm(x, r, w, b, 1e-6, ls)
    want_s, want_y = add_layernorm_ref(x, r, w, b, 1e-6, ls)
    assert torch.equal(s, want_s) and torch.equal(y, want_y)
    assert torch.equal(layernorm(x, w, b, 1e-6), layernorm_ref(x, w, b, 1e-6))
    assert _build.launches.get("layernorm", 0) == 0


def test_other_devices_are_refused():
    x = torch.empty(4, 16, device="meta")
    w = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        add_layernorm(x, x, w, w, 1e-6)
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        layernorm(x, w, w, 1e-6)


def _misaligned(rows, dim, dtype):
    flat = torch.zeros(rows * dim + 1, dtype=dtype)
    return flat[1:].view(rows, dim)


def _refusal(case):
    """(x, r, weight, bias, gamma) that ``case`` makes K8 refuse."""
    x, r, w, b, ls = _inputs(torch.bfloat16, rows=8, dim=32, seed=3, gamma=True)
    if case == "float16":
        return x.half(), r.half(), w, b, None
    if case == "width_not_a_multiple_of_8":
        return x[:, :12].contiguous(), r[:, :12].contiguous(), w[:12], b[:12], None
    if case == "row_wider_than_a_warp_holds":
        wide = torch.zeros(2, 4104, dtype=torch.bfloat16)
        return wide, wide, torch.ones(4104), torch.zeros(4104), None
    if case == "x_not_contiguous":
        sq = torch.zeros(32, 32, dtype=torch.bfloat16)
        return sq.t(), sq, w, b, None
    if case == "x_misaligned":
        return _misaligned(8, 32, torch.bfloat16), r, w, b, None
    if case == "r_misaligned":
        return x, _misaligned(8, 32, torch.bfloat16), w, b, None
    if case == "r_shape":
        return x, r[:4], w, b, None
    if case == "r_dtype":
        return x, r.float(), w, b, None
    if case == "gamma_dtype":
        return x, r, w, b, ls.float()
    if case == "weight_dtype":
        return x, r, w.bfloat16(), b, None
    if case == "bias_shape":
        return x, r, w, b[:16], None
    if case == "weight_device":
        return x, r, torch.empty(32, device="meta"), b, None
    if case == "requires_grad":
        return x, r, w.requires_grad_(), b, None
    raise AssertionError(case)


REFUSALS = {
    "float16": "bfloat16 or float32 activations",
    "width_not_a_multiple_of_8": "width is a multiple of 8",
    "row_wider_than_a_warp_holds": "holds a row in one warp's registers",
    "x_not_contiguous": "contiguous tensors; x is not",
    "x_misaligned": "x must start on a 16-byte boundary",
    "r_misaligned": "r must start on a 16-byte boundary",
    "r_shape": r"takes r as \(8, 32\) torch.bfloat16",
    "r_dtype": r"takes r as \(8, 32\) torch.bfloat16",
    "gamma_dtype": r"takes gamma as \(32,\) torch.bfloat16",
    "weight_dtype": r"takes weight as \(32,\) torch.float32",
    "bias_shape": r"takes bias as \(32,\) torch.float32",
    "weight_device": "weight is on meta",
    "requires_grad": "no backward",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, r, w, b, ls = _refusal(case)
    with pytest.raises(ValueError, match=REFUSALS[case]):
        k8._check(x, r, w, b, ls)


def test_wrapper_takes_the_chains_tensors():
    for gamma in (False, True):
        for dtype in DTYPES:
            x, r, w, b, ls = _inputs(dtype, rows=8, dim=32, seed=4, gamma=gamma)
            k8._check(x, r, w, b, ls)
            k8._check(x, None, w, b, None)
    with torch.no_grad():  # the model's parameters require grad; the chain runs with grad off
        k8._check(x, r, w.requires_grad_(), b, None)


# ---- the ViTs' chain --------------------------------------------------------


def _seeded(model, seed, std=0.2):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("ln1.weight") or name.endswith("ln2.weight") or name == "ln.weight":
                p.copy_(1 + std * torch.randn(p.shape, generator=g))
            else:
                p.copy_(std * torch.randn(p.shape, generator=g))
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
            elif name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
    return model.eval()


def _model(kind, dtype):
    if kind == "vit_linear":
        return _seeded(ViT(5, patch=8, dim=64, depth=3, heads=2, dtype=dtype, img_size=32), 10), 32
    if kind == "vit_conv":
        return _seeded(ViT(5, patch=8, dim=32, depth=2, heads=2, dtype=dtype, stem="conv",
                           img_size=32), 11), 32
    if kind == "folded_stem":
        inner = _seeded(ViT(5, patch=8, dim=32, depth=2, heads=2, dtype=dtype, stem="conv",
                            img_size=32), 12)
        return fold_vit_stem(inner), 32
    if kind == "regvit":
        return _seeded(RegViT(5, patch=14, dim=64, depth=2, heads=2, mlp_hidden=64,
                              reg_tokens=8, dtype=dtype, img_size=56), 13, std=0.3), 56
    raise AssertionError(kind)


def _depth(model):
    return getattr(model, "inner", model).depth


class ChainSpy:
    """Counts the chain's calls of K8's two entry points in ``models.vit``."""

    def __init__(self, monkeypatch):
        self.calls = {"layernorm": 0, "add_layernorm": 0}
        for name in self.calls:
            fn = getattr(vit_module, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(vit_module, name, counted)


def _old_forward(model, x):
    """``ViT.forward`` before the chain (the block loop, then ``classify``),
    as the model or, for a folded stem, its inner ViT runs it."""
    if not hasattr(model, "inner"):
        return _old_forward_vit(model, x)
    model.inner.forward = partial(_old_forward_vit, model.inner)
    try:
        return model(x)
    finally:
        del model.inner.forward


def _old_forward_vit(vit, x, tokens=False):
    x = vit.embed_tokens(x, tokens)
    for i in range(vit.depth):
        x = getattr(vit, f"block{i}")(x)
    return vit.classify(x)


KINDS = ("vit_linear", "vit_conv", "folded_stem", "regvit")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grad_off_chain_equals_the_block_loop(monkeypatch, kind, dtype):
    model, side = _model(kind, dtype)
    x = torch.rand(3, side, side, 3, generator=torch.Generator().manual_seed(5))
    want = _old_forward(model, x)
    spy = ChainSpy(monkeypatch)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            got = model(x)
        assert got.dtype == torch.float32 and torch.equal(got, want.detach()), mode
    depth = _depth(model)
    assert spy.calls == {"layernorm": 2, "add_layernorm": 2 * 2 * depth}


@pytest.mark.parametrize("kind", ("vit_linear", "regvit"))
def test_grad_on_runs_the_block_loop_with_its_gradients(monkeypatch, kind):
    model, side = _model(kind, torch.float32)
    x = torch.rand(2, side, side, 3, generator=torch.Generator().manual_seed(6))
    spy = ChainSpy(monkeypatch)
    got = model(x)
    got_grads = torch.autograd.grad(got.square().sum(), list(model.parameters()))
    want = _old_forward(model, x)
    want_grads = torch.autograd.grad(want.square().sum(), list(model.parameters()))
    assert spy.calls == {"layernorm": 0, "add_layernorm": 0}
    assert torch.equal(got, want)
    for (name, _), g, w in zip(model.named_parameters(), got_grads, want_grads):
        assert torch.equal(g, w), name
