"""The UNI2-h ViT (``models/vit.py:RegViT``, blocks ``GatedBlock``) against
the benchmark's plain float32 reference (``port_bench/reference/uni2h.py``,
the one copy of it), and kernel K7's plain version (``ops/swiglu.py``).

The models are narrow (dim 128, 2 heads of 64, 2 blocks, gated width 256,
8 registers) at patch 14 on 56² inputs, so a patch carries 1 + 8 + 16 = 25
tokens; their weights are the benchmark's seeded draw (LayerScale γ about
0.5, so every block contributes). Tolerances, as a share of the largest
|logit| of the reference:

* float32: 1e-5. The port and the reference compute the same float32
  operations in another order (readings 7e-7 to 1.1e-6).
* bfloat16: 4e-2. Every Dense, the attention and the residual stream round
  to bf16 (8 bits), and LayerNorm rescales those errors (readings 9e-3 to
  2.5e-2). The reference in float8 e4m3 wherever the model holds bf16, the
  benchmark's control, reads 0.15 to 0.22 at the same seeds, so the bf16
  tolerance catches the model one precision lower.

This file imports no JAX. Its ``gpu`` tests decide in their body whether a
card is present and skip without one: on the card,
``python -m pytest -m gpu tests/test_torch_vit_reg.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deephisto_tpu_torch import _build, profiling
from deephisto_tpu_torch.models import RegViT, quantize_vit
from deephisto_tpu_torch.models import vit as vit_module
from deephisto_tpu_torch.models.patch_cls_simple import get_model
from deephisto_tpu_torch.ops import swiglu, swiglu_bwd_ref, swiglu_ref
from deephisto_tpu_torch.predict import predict_full_fused
from deephisto_tpu_torch.serve.engine import ServingEngine
from port_bench.families import vit_reg as family
from port_bench.reference import maps
from port_bench.reference import uni2h as ref
from port_bench.reference.common import precise

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(num_classes=5, patch=14, dim=128, depth=2, heads=2, mlp_hidden=256, reg_tokens=8)
TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
SEEDS = (0, 1, 2)


def cfg(size=56, **kw):
    return dict(NARROW, patch_size=size, **kw)


def seeded(seed=0, dtype=torch.float32, size=56, **kw):
    """(the benchmark's seeded state dict, the port's model holding it)."""
    c = cfg(size, **kw)
    sd = family.make_weights(c, seed, "cpu")
    model = RegViT(c["num_classes"], patch=c["patch"], dim=c["dim"], depth=c["depth"],
                   heads=c["heads"], mlp_hidden=c["mlp_hidden"], reg_tokens=c["reg_tokens"],
                   dtype=dtype, img_size=size)
    model.load_state_dict(sd, strict=True)
    return sd, model.eval()


def images(n, size=56, seed=0):
    return torch.rand(n, size, size, 3, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_the_reference(dtype, seed):
    sd, model = seeded(seed, dtype)
    x = images(4, seed=seed)
    with precise():
        want = ref.forward(sd, cfg(), x)
        control = ref.forward(sd, cfg(), x, control=True)
    with torch.no_grad():
        got = model(x)
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL[dtype] * scale
    # the control (float8 products) lies outside the bf16 tolerance
    assert float((control - want).abs().max()) > TOL[torch.bfloat16] * scale


def test_token_order_and_position_embedding_on_patches_only():
    _, model = seeded(3)
    x = images(2, seed=3)
    with torch.no_grad():
        model.cls_token.fill_(7.0)
        model.reg_token.copy_(torch.arange(8.0).view(1, 8, 1).expand(1, 8, 128))
        t = model.embed_tokens(x)
        model.pos_embed.zero_()
        t0 = model.embed_tokens(x)
    assert t.shape == (2, 1 + 8 + 16, 128) and model.n_tokens == 25
    assert torch.equal(t[:, 0], torch.full((2, 128), 7.0))
    assert torch.equal(t[:, 1:9], torch.arange(8.0).view(1, 8, 1).expand(2, 8, 128))
    assert torch.equal(t[:, :9], t0[:, :9])  # no position on the class and register tokens
    sd = model.state_dict()
    assert not torch.equal(t[:, 9:], t0[:, 9:])
    with torch.no_grad():
        pos = family.make_weights(cfg(), 3, "cpu")["pos_embed"]
    torch.testing.assert_close(t[:, 9:] - t0[:, 9:], pos.expand(2, -1, -1))
    assert sd["pos_embed"].shape == (1, 16, 128)


def test_the_input_is_normalised_before_the_patch_conv():
    """The patch tokens are the stride-14 conv of ``(x − mean) / std``."""
    _, model = seeded(4)
    x = images(2, seed=4)
    mean, std = torch.tensor(ref.MEAN), torch.tensor(ref.STD)
    with torch.no_grad():
        t = model.embed_tokens(x)
        pos = model.pos_embed
        want = torch.nn.functional.conv2d(((x - mean) / std).permute(0, 3, 1, 2),
                                          model.embed.weight, model.embed.bias, stride=14)
    want = want.permute(0, 2, 3, 1).reshape(2, 16, 128) + pos
    torch.testing.assert_close(t[:, 9:], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_plain_version_against_float64(dtype):
    g = torch.Generator().manual_seed(5)
    u = (torch.randn(37, 2 * 96, generator=g) * 4).to(dtype)
    a, b = u[:, :96].double(), u[:, 96:].double()
    want = a / (1 + torch.exp(-a)) * b
    got = swiglu_ref(u)
    assert got.dtype == dtype and got.shape == (37, 96)
    # float32: a few float32 roundings; bf16: the one rounding of the output
    rtol = 1e-6 if dtype == torch.float32 else 2.0**-8
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=1e-30)
    assert torch.equal(swiglu(u), got)  # the CPU takes the plain version


def test_gate_backward_against_autograd():
    u = torch.randn(9, 2 * 40, dtype=torch.float64, generator=torch.Generator().manual_seed(6),
                    requires_grad=True)
    grad = torch.randn(9, 40, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    (want,) = torch.autograd.grad(swiglu_ref(u), u, grad)
    torch.testing.assert_close(swiglu_bwd_ref(u.detach(), grad), want, rtol=1e-12, atol=1e-12)


def test_gate_refuses_an_odd_width():
    with pytest.raises(ValueError, match="2h"):
        swiglu_ref(torch.zeros(3, 5))


def test_published_model_on_the_meta_device():
    conf = json.loads((ROOT / "port_bench" / "configs" / "uni2h_bf16.json").read_text())
    with torch.device("meta"):
        model = get_model(conf["num_classes"], depth=24, arch="uni2h")
    assert isinstance(model, vit_module.ViT) and isinstance(model, RegViT)
    trunk = sum(p.numel() for k, p in model.named_parameters() if not k.startswith("head."))
    assert trunk == 681_394_176
    assert model.n_tokens == 265 and model.n_patches == 256
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["block0.fc1.weight"] == (8192, 1536)
    assert shapes["block23.fc2.weight"] == (1536, 4096)
    assert shapes["block0.attn.qkv.weight"] == (4608, 1536)
    assert shapes["embed.weight"] == (1536, 3, 14, 14)
    assert shapes["reg_token"] == (1, 8, 1536) and shapes["pos_embed"] == (1, 256, 1536)
    assert shapes["block5.ls1"] == shapes["block5.ls2"] == (1536,)
    # the benchmark's configuration builds the same tensors
    with torch.device("meta"):
        bench = family.program_model(conf)
    assert {k: tuple(v.shape) for k, v in bench.state_dict().items()} == shapes
    assert conf["parameters"] == trunk and conf["tokens"] == model.n_tokens


def test_get_model_names_the_new_arch():
    with pytest.raises(ValueError, match="'uni2h'"):
        get_model(5, arch="nope")
    with pytest.raises(ValueError, match="depth 1..24"):
        get_model(5, depth=25, arch="uni2h")


def test_int8_is_refused_with_what_is_missing():
    _, model = seeded(8)
    engine_cfg = {"model": {"n_classes": 5, "arch": "uni2h"}, "dataset": {"patch_size": 56}}
    for build in (lambda: quantize_vit(model, [np.zeros((2, 56, 56, 3), np.float32)]),
                  lambda: ServingEngine(model, engine_cfg, int8=True, mode="dense",
                                        device="cpu")):
        with pytest.raises(ValueError, match="gated .SwiGLU. MLP, LayerScale") as e:
            build()
        assert "register tokens" in str(e.value)


def _slide(h, w, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 255, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
    return np.ascontiguousarray(img)


def test_engine_dense_map_matches_the_reference():
    """``ServingEngine``'s dense mode (``predict_full_fused``: K1's plain
    gather, the model, K2's plain stitch) on a 336×448 slide against the
    reference's scores on every map cell whose best class leads the next by
    more than 1e-4 of the scores' spread (the float32 model and the
    reference differ by about 1e-6)."""
    size = 224
    c = cfg(size)
    sd, model = seeded(9, size=size)
    slide = _slide(336, 448, 9)
    corners = np.random.default_rng(9).integers(0, [336 - size + 1, 448 - size + 1], (32, 2))
    family.fit_head(c, sd, torch.from_numpy(np.stack([slide[y:y + size, x:x + size]
                                                      for y, x in corners])), 9)
    model.load_state_dict(sd)
    engine = ServingEngine(model, {"model": {"n_classes": 5, "arch": "uni2h"},
                                   "dataset": {"patch_size": size}}, mode="dense", device="cpu")
    amap, meta = engine.predict_slide(image=slide)
    assert amap.shape == (21, 28) and meta["mode"] == "dense"
    cells = np.stack(np.meshgrid(np.arange(21), np.arange(28), indexing="ij"), -1).reshape(-1, 2)
    scores = maps.dense_cell_scores(torch.from_numpy(slide), family.Reference(c, sd, "cpu")
                                    .slide_logits(), cells, size, 112, 16)
    top2 = scores.topk(2, dim=1).values
    spread = float((scores.max(1).values - scores.min(1).values).median())
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * spread
    assert int(clear.sum()) > 0.9 * len(cells)
    assert np.array_equal(amap[cells[:, 0], cells[:, 1]][clear.numpy()],
                          scores.argmax(1)[clear].numpy())
    assert len(set(amap.ravel().tolist())) > 1  # the fitted head splits the slide


def test_gate_calls_and_enqueue_tokens_per_batch(monkeypatch):
    """24 gates a 256-patch batch at depth 24 (K7's launches on the card,
    counted by ``_build.launches`` there), and the ``predict.enqueue`` span
    carries the tokens a patch has."""
    calls = []
    monkeypatch.setattr(vit_module, "swiglu", lambda u: calls.append(u.shape) or swiglu_ref(u))
    _, model = seeded(10, size=56, depth=24, dim=64, heads=1, mlp_hidden=64)
    slide = _slide(84, 392, 10)  # 2 × 13 patches of 56² at stride 28: 2 batches of 16
    last = max((s.id for s in profiling.spans()), default=0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        predict_full_fused(slide, model, 5, patch_size=56, stride=28, batch_size=16,
                           device="cpu")
    assert len(calls) == 24 * 2 and calls[0] == (16, 25, 128)
    enqueue = [s for s in profiling.spans() if s.id > last and s.name == "predict.enqueue"]
    assert [s.attrs for s in enqueue] == [{"batches": 2, "tokens": 25}]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,h", [(torch.bfloat16, 67_840, 4096), (torch.bfloat16, 261, 4096),
                                          (torch.bfloat16, 5, 8), (torch.float32, 1_000, 4096),
                                          (torch.float32, 3, 4)])
def test_k7_matches_its_plain_version(dtype, rows, h):
    """K7 against its plain version on the card: the same float32 sequence
    (expf, an IEEE division, the product) rounded once, so equal but for a
    different libm exp, which may move the float32 value by an ulp and, at a
    rounding boundary, the bf16 output by one ulp (2^-8 relative)."""
    _need_card()
    dev = torch.device("cuda", 0)
    u = (torch.randn(rows, 2 * h, device=dev, generator=torch.Generator(dev).manual_seed(rows))
         * 3).to(dtype)
    _build.reset_launches()
    got = swiglu(u)
    torch.cuda.synchronize()
    want = swiglu_ref(u)
    assert got.shape == (rows, h) and got.dtype == dtype
    assert _build.launches.get("swiglu") == 1
    rtol = 2.0**-8 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-30)


@pytest.mark.gpu
def test_k7_backward_and_launches_per_batch():
    _need_card()
    dev = torch.device("cuda", 0)
    u = torch.randn(64, 2 * 64, device=dev, requires_grad=True)
    grad = torch.randn(64, 64, device=dev)
    (got,) = torch.autograd.grad(swiglu(u), u, grad)
    (want,) = torch.autograd.grad(swiglu_ref(u), u, grad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # 24 launches a 256-patch batch at depth 24 through the dense predict
    _, model = seeded(11, dtype=torch.bfloat16, size=224, depth=24, dim=128, heads=2,
                      mlp_hidden=64)
    model = model.to(dev)
    slide = _slide(336, 2016, 11)  # 2 × 17 patches: one batch of 256
    _build.reset_launches()
    predict_full_fused(slide, model, 5, device=dev)
    torch.cuda.synchronize()
    assert _build.launches.get("swiglu") == 24
