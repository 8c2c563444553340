"""The plain reference against itself at tiny sizes, and its imports."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.core.weights import draw
from port_bench.families import resnet as fam_resnet
from port_bench.families import vit as fam_vit
from port_bench.reference import common, maps
from port_bench.reference import resnet as ref
from port_bench.reference import vit as ref_vit

ROOT = Path(__file__).resolve().parents[2]
TINY = {"stage_sizes": [1, 1], "width": 1}


def tiny_resnet_sd(seed=0):
    """A two-stage BasicBlock ResNet's raw state dict (stem 64, stages 64
    and 128), drawn as the ResNet family draws its weights."""
    shapes = {"conv1.weight": (64, 48, 2, 2)}
    for n, c in (("bn1", 64),):
        shapes.update({f"{n}.{k}": (c,) for k in ("weight", "bias", "running_mean",
                                                   "running_var")})
    def block(name, cin, cout, ds):
        shapes[f"{name}.conv1.weight"] = (cout, cin, 3, 3)
        shapes[f"{name}.conv2.weight"] = (cout, cout, 3, 3)
        bns = ["bn1", "bn2"] + (["downsample_bn"] if ds else [])
        if ds:
            shapes[f"{name}.downsample_conv.weight"] = (cout, cin, 1, 1)
        for b in bns:
            shapes.update({f"{name}.{b}.{k}": (cout,) for k in ("weight", "bias",
                                                                 "running_mean", "running_var")})
    block("layer1_0", 64, 64, False)
    block("layer2_0", 64, 128, True)
    shapes["fc.weight"], shapes["fc.bias"] = (5, 128), (5,)
    rules = {k: fam_resnet._rule(k, s) for k, s in shapes.items()}
    return draw(shapes, rules, seed, "cpu")


def test_int_conv_is_exact():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 9, 11, 16), generator=g).float()
    w = torch.randint(-127, 128, (8, 3, 3, 16), generator=g).float()
    for stride in (1, 2):
        got = common.int_conv(x, w, stride)
        pads = (common.same_pads(9, 3, stride), common.same_pads(11, 3, stride))
        cols, (n, oh, ow) = common.im2col(x.long(), 3, stride, pads)
        want = (cols @ w.reshape(8, -1).long().t()).reshape(n, oh, ow, 8)
        assert torch.equal(got.long(), want)


def test_fold_keeps_the_float_model():
    sd = tiny_resnet_sd()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    folded = ref.fold(sd, TINY["stage_sizes"])
    # the folded forward of calibrate's walk, logits from it by the head
    h = torch.relu(common.conv_nhwc(common.s2d4(x), folded["conv1"][0], 1) + folded["conv1"][1])
    for name, s in ref.blocks(TINY["stage_sizes"]):
        y = torch.relu(common.conv_nhwc(h, *folded[f"{name}.conv1"][:1], s)
                       + folded[f"{name}.conv1"][1])
        y = common.conv_nhwc(y, folded[f"{name}.conv2"][0], 1) + folded[f"{name}.conv2"][1]
        r = (common.conv_nhwc(h, folded[f"{name}.downsample_conv"][0], s)
             + folded[f"{name}.downsample_conv"][1]) if f"{name}.downsample_conv" in folded else h
        h = torch.relu(r + y)
    want = h.mean((1, 2)) @ sd["fc.weight"].t() + sd["fc.bias"]
    got = ref.float_forward(sd, TINY["stage_sizes"], x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_int8_reference_is_near_the_float_model_and_int4_far():
    sd = tiny_resnet_sd(3)
    g = torch.Generator().manual_seed(2)
    calib = [torch.rand(8, 64, 64, 3, generator=g)]
    u8 = torch.randint(0, 256, (6, 64, 64, 3), generator=g, dtype=torch.uint8)
    fl = ref.float_forward(sd, TINY["stage_sizes"], u8.float() / 255.0)
    q8 = ref.QuantRef(sd, TINY["stage_sizes"], calib, 127)
    q4 = ref.QuantRef(sd, TINY["stage_sizes"], None, 7, absmax=q8.absmax)
    e8 = (q8.logits(u8) - fl).abs().max() / fl.abs().max()
    e4 = (q4.logits(u8) - fl).abs().max() / fl.abs().max()
    assert e8 < 0.05 and e4 > 3 * e8
    assert q8.features(u8).shape == (6, 8, 8, 128)  # two stages: stride 8
    assert torch.equal(q8.logits(u8), q8.logits(u8))  # integer sums: exact, repeatable


def test_dense_cell_scores_sum_the_covering_patches():
    g = torch.Generator().manual_seed(4)
    slide = torch.randint(0, 256, (352, 464, 3), generator=g, dtype=torch.uint8)
    coords = maps.dense_coords(352, 464)

    def logits(u8):  # a linear stand-in for a model: per-patch channel means
        return u8.float().mean((1, 2))

    full = torch.zeros(352 // 16, 464 // 16, 3)
    for y, x in coords.tolist():
        full[y // 16:(y + 224) // 16, x // 16:(x + 224) // 16] += logits(
            slide[None, y:y + 224, x:x + 224])[0]
    cells = np.array([[0, 0], [21, 28], [10, 13], [7, 20]])
    got = maps.dense_cell_scores(slide, logits, cells, batch=3)
    assert torch.allclose(got, full[cells[:, 0], cells[:, 1]], rtol=1e-5)


def test_fcn_cell_scores_match_a_whole_map():
    """The fcn reference at sampled cells against the whole map computed
    directly: every window's mean logit, each cell the mean over the
    windows covering it, the tail replicating the last covered cell."""
    g = torch.Generator().manual_seed(5)
    h, w, tile, halo = 480, 416, 128, 32
    slide = torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8)
    fc_w, fc_b = torch.randn(4, 3, generator=g), torch.randn(3, generator=g)

    def features(u8):  # 32 × 32 block means of the 4 channels (RGB, R+G)
        f = u8.float()
        f = torch.cat([f, f[..., :1] + f[..., 1:2]], -1)
        b, s = f.shape[0], f.shape[1] // 32
        return f.reshape(b, s, 32, s, 32, 4).mean((2, 4))

    ty, tx = -(-h // tile), -(-w // tile)
    ft = tile // 32
    lmap = torch.zeros(ty * ft, tx * ft, 3)
    for r in range(ty):
        for c in range(tx):
            rows = (torch.arange(tile + 2 * halo) + r * tile - halo).clamp(0, h - 1)
            cols = (torch.arange(tile + 2 * halo) + c * tile - halo).clamp(0, w - 1)
            t = slide.index_select(0, rows).index_select(1, cols)
            lmap[r * ft:(r + 1) * ft, c * ft:(c + 1) * ft] = (
                features(t[None])[0, 1:1 + ft, 1:1 + ft] @ fc_w)
    ky, kx = (h - 224) // 32 + 1, (w - 224) // 32 + 1
    win = torch.stack([torch.stack([lmap[a:a + 7, b:b + 7].reshape(-1, 3).mean(0)
                                    for b in range(kx)]) for a in range(ky)]) + fc_b
    full = torch.zeros(h // 16, w // 16, 3)
    for my in range(h // 16):
        for mx in range(w // 16):
            iy, ix = min(my // 2, ky + 5), min(mx // 2, kx + 5)
            full[my, mx] = win[max(0, iy - 6):min(iy, ky - 1) + 1,
                               max(0, ix - 6):min(ix, kx - 1) + 1].reshape(-1, 3).mean(0)
    cells = np.array([[0, 0], [29, 25], [14, 3], [3, 17], [22, 25], [29, 0]])
    got = maps.fcn_cell_scores(slide, features, fc_w, fc_b, cells, tile, halo, batch=2)
    assert torch.allclose(got, full[cells[:, 0], cells[:, 1]], rtol=1e-4, atol=1e-3)


def test_gap_numbers():
    ref_s = torch.tensor([[3.0, 1.0, 0.0], [0.0, 2.0, 1.0], [1.0, 1.0, 5.0]])
    assert maps.gap_numbers(ref_s, [0, 1, 2]) == {"map_gap": 0.0, "map_gap_mean": 0.0}
    got = maps.gap_numbers(ref_s, [1, 1, 2])  # the median spread is 3
    assert got["map_gap"] == pytest.approx(2.0 / 3.0)
    assert got["map_gap_mean"] == pytest.approx(2.0 / 9.0)
    got = maps.gap_numbers(ref_s, [0, 1, 9])  # no such class: the spread plus one
    assert got["map_gap"] == pytest.approx((5.0 - 1.0 + 3.0) / 3.0)


def test_vit_reference_fp8_control_moves_the_logits():
    cfg = {"patch": 8, "dim": 32, "heads": 2, "depth": 2}
    shapes = {"embed.weight": (32, 3, 8, 8), "embed.bias": (32,), "pos_embed": (1, 16, 32),
              "ln.weight": (32,), "ln.bias": (32,), "head.weight": (5, 32),
              "head.bias": (5,)}
    for i in range(2):
        for n, s in (("ln1.weight", (32,)), ("ln1.bias", (32,)), ("ln2.weight", (32,)),
                     ("ln2.bias", (32,)), ("attn.qkv.weight", (96, 32)),
                     ("attn.qkv.bias", (96,)), ("attn.proj.weight", (32, 32)),
                     ("attn.proj.bias", (32,)), ("fc1.weight", (128, 32)),
                     ("fc1.bias", (128,)), ("fc2.weight", (32, 128)), ("fc2.bias", (32,))):
            shapes[f"block{i}.{n}"] = s
    sd = draw(shapes, {k: fam_vit._rule(k, s) for k, s in shapes.items()}, 1, "cpu")
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    a = ref_vit.forward(sd, cfg, x)
    b = ref_vit.forward(sd, cfg, x, mm=ref_vit.fp8_mm)
    assert a.shape == (3, 5) and torch.equal(a, ref_vit.forward(sd, cfg, x))
    assert 1e-3 < float((a - b).abs().max() / a.abs().max()) < 0.5


def test_reference_imports_nothing_of_the_program_or_jax():
    code = (
        "import sys, pkgutil, importlib, port_bench.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__): importlib.import_module('port_bench.reference.' + m.name)\n"
        "bad = {m.split('.')[0] for m in sys.modules} & set(r.FORBIDDEN_IMPORTS)\n"
        "print(sorted(bad)); sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
