"""The port's kernels against their plain PyTorch versions, and the plain
versions against numpy loops. This file imports no JAX, so it also runs on
the machine with the card: ``python -m pytest -m gpu tests/test_torch_kernels.py``.
The ``gpu`` tests decide in their body whether a card is present and skip
without one."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deephisto_tpu_torch import _build
from deephisto_tpu_torch.models.resnet import same_pads
from deephisto_tpu_torch.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
    gather_multi_u8,
    gather_normalize,
    gather_normalize_ref,
    gather_quantize_int8,
    gather_quantize_int8_ref,
    scatter_add_map,
    scatter_add_map_exact,
    scatter_add_map_ref,
)
from deephisto_tpu_torch.ops import attention as att
from deephisto_tpu_torch.ops import conv_int8 as k6
from deephisto_tpu_torch.ops import flash_attention_qkv
from deephisto_tpu_torch.ops.attention import _forward as flash_forward


def _image(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _patch_coords(h, w, ps, n, seed=1):
    rng = np.random.default_rng(seed)
    fixed = [(0, 0), (h - ps, w - ps), (h - ps, 7), (5, w - ps), (17, 33)]
    rand = rng.integers(0, [h - ps + 1, w - ps + 1], size=(n, 2))
    return np.concatenate([fixed, rand]).astype(np.int32)


def _map_coords(h, w, ps, n, seed=0):
    """Layer coords: a dense grid plus random ones, some off the map."""
    rng = np.random.default_rng(seed)
    grid = [(y, x) for y in range(0, h - ps + 1, ps // 2) for x in range(0, w - ps + 1, ps // 2)]
    return np.concatenate([grid, rng.integers(0, [h + ps, w + ps], size=(n, 2))]).astype(np.int32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_normalize_ref_is_slice_then_divide(dtype):
    img = _image(200, 300)
    coords = _patch_coords(200, 300, 50, 10)
    got = gather_normalize_ref(torch.from_numpy(img), coords, 50, dtype)
    for i, (y, x) in enumerate(coords):
        patch = img[y : y + 50, x : x + 50]
        if dtype == torch.float32:  # u8 · f32(1/255), as the Pallas kernel
            want = torch.from_numpy(patch.astype(np.float32) * np.float32(1 / 255))
        else:  # bf16(u8) / bf16(255), as model_input
            want = torch.from_numpy(patch.copy()).to(dtype) / torch.tensor(255.0, dtype=dtype)
        assert torch.equal(got[i], want)


def test_scatter_add_map_ref_is_the_host_loop():
    rng = np.random.default_rng(3)
    dh, dw, c, f = 40, 50, 5, 9
    coords = rng.integers(-4, 52, size=(30, 2)).astype(np.int32)
    vals = rng.standard_normal((30, c)).astype(np.float32)
    coords[:3] = [(-dh - 2, 0), (-3, -dw), (-45, 48)]  # dropped, wrapped, straddling
    got = scatter_add_map_ref(torch.zeros(dh, dw, c), coords, torch.from_numpy(vals), f)
    want = np.zeros((dh, dw, c), np.float32)
    for (y, x), v in zip(coords, vals):  # cell by cell, indices in [-d, 0) wrapped
        for a in range(f):
            for b in range(f):
                yy, xx = y + a + (dh if y + a < 0 else 0), x + b + (dw if x + b < 0 else 0)
                if 0 <= yy < dh and 0 <= xx < dw:
                    want[yy, xx] += v
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_gather_normalize_kernel_matches_plain_on_card():
    _need_card()
    coords = torch.from_numpy(_patch_coords(1024, 1536, 224, 60))
    for c in (3, 48):
        img = torch.from_numpy(_image(1024, 1536, c)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            _build.reset_launches()
            got = gather_normalize(img, coords, 224, dt)
            torch.cuda.synchronize()
            assert _build.launches["gather_normalize"] == 1
            assert torch.equal(got, gather_normalize_ref(img, coords, 224, dt))
    img = torch.from_numpy(_image(1024, 1536)).cuda()
    odd = gather_normalize(img, coords.cuda(), 57, torch.bfloat16)  # ps*C % 4 != 0
    assert torch.equal(odd, gather_normalize_ref(img, coords, 57, torch.bfloat16))
    off = torch.tensor([[1024 - 223, 0]], dtype=torch.int32).cuda()  # clamped, not refused
    assert torch.equal(gather_normalize(img, off, 224), gather_normalize_ref(img, off, 224))


@pytest.mark.gpu
def test_gather_normalize_kernel_clamps_off_slide_coords_on_card():
    """K1 clamps coords that leave the slide on each side, negative ones
    included, as its plain version (lax.dynamic_slice's rule) does."""
    _need_card()
    rng = np.random.default_rng(6)
    for ps, c in ((224, 3), (57, 3), (64, 48)):
        img = torch.from_numpy(_image(700, 900, c)).cuda()
        coords = rng.integers(-1200, 1200, size=(80, 2)).astype(np.int32)
        coords[:8] = [(-1, 0), (0, -1), (700 - ps + 1, 0), (0, 900 - ps + 1), (-ps, -900),
                      (-701, 5), (699, 899), (5000, -5000)]
        for dt in (torch.float32, torch.bfloat16):
            _build.reset_launches()
            got = gather_normalize(img, torch.from_numpy(coords).cuda(), ps, dt)
            torch.cuda.synchronize()
            assert _build.launches["gather_normalize"] == 1
            assert torch.equal(got, gather_normalize_ref(img, coords, ps, dt)), (ps, c, dt)


@pytest.mark.gpu
def test_kernels_leave_the_current_device_as_it_was():
    _need_card()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)  # another card where there is one
    torch.cuda.set_device(0)
    img = torch.from_numpy(_image(256, 256)).to(dev)
    gather_normalize(img, torch.tensor([[3, 5]], dtype=torch.int32), 224)
    assert torch.cuda.current_device() == 0
    scatter_add_map(torch.zeros((4, 4, 1), device=dev), torch.tensor([[1, 1]], dtype=torch.int32),
                    torch.ones(1, device=dev), 2)
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_scatter_add_map_kernel_matches_plain_on_card():
    _need_card()
    h, w = 4096, 3000
    for ps, d in [(224, 16), (200, 16)]:
        coords = torch.from_numpy(_map_coords(h, w, ps, 300)).cuda()
        vals = torch.randn(len(coords), 5, device="cuda")
        runs = [
            scatter_add_map_exact(torch.zeros((h // d, w // d, 5), device="cuda"), coords, vals, ps, d)
            for _ in range(2)
        ]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])  # deterministic
        spans = None if ps % d == 0 else (coords % d + ps) // d
        f = ps // d if ps % d == 0 else ps // d + 1
        want = scatter_add_map_ref(torch.zeros_like(runs[0]), coords // d, vals, f, spans)
        torch.testing.assert_close(runs[0], want, atol=1e-5, rtol=0)
    # negative map coords: wrapped from [-dh, 0), dropped below, straddling
    # patches in up to four rectangles; f > dh hits a cell twice
    rng = np.random.default_rng(7)
    for (dh, dw), f, spans in (((256, 188), 14, False), ((200, 300), 15, True),
                               ((9, 40), 12, False)):
        coords = rng.integers([-dh - f, -dw - f], [dh + 2, dw + 2], size=(400, 2))
        coords = torch.from_numpy(coords.astype(np.int32)).cuda()
        vals = torch.randn(len(coords), 5, device="cuda")
        sp = torch.randint(0, f + 2, (len(coords), 2), dtype=torch.int32).cuda() if spans else None
        runs = [scatter_add_map(torch.zeros((dh, dw, 5), device="cuda"), coords, vals, f, sp)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
        want = scatter_add_map_ref(torch.zeros_like(runs[0]), coords, vals, f, sp)
        assert torch.equal(runs[0], want), (dh, dw, f, spans)  # the same sums in the same order


# K3's tolerances, as chip_smoke.py holds them: bf16 outputs within 1 % of the
# largest |output| (P and the output each round to bf16, against other maxima
# than the plain version's); f32 within 1e-4 (ex2.approx and another
# summation order than the f32 matmuls of the plain version).
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _k3_error(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    return err / float(want.float().abs().max()) if dtype == torch.bfloat16 else err


@pytest.mark.parametrize("dtype,dh,design", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "mma.sync"),
    (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 128, "mma.sync"),
    (torch.float32, 16, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
])
def test_backward_design_by_dtype_and_head_width(dtype, dh, design):
    """The (dtype, Dh) -> design dispatch of K4 and K5, as the wrapper hands
    it to the kernels' entry points (which refuse any other)."""
    assert att.attention_design(dtype, dh) == design


@pytest.mark.parametrize("dtype,dh,design", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "mma.sync"),
    (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 128, "mma.sync"),
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"),
])
def test_forward_design_by_dtype_and_head_width(dtype, dh, design):
    """K3 takes its design from the same chooser as K4 and K5, and the
    wrapper passes its code as the entry point's design argument."""
    assert att.attention_design(dtype, dh) == design
    argtypes = att._SIGNATURE["dh_flash_attention"]
    assert len(argtypes) == 15 and argtypes[11] is ctypes.c_int  # ..., elem_bytes, design, ...


def test_backward_design_codes_are_the_kernels_enum():
    """The codes the wrapper passes are those of csrc/flash_common.cuh:Design,
    which K3's and K4/K5's entry points read."""
    src = (Path(att.__file__).parents[1] / "csrc" / "flash_common.cuh").read_text()
    enum = re.search(r"enum Design : int \{([^}]*)\}", src).group(1)
    codes = {name: int(code) for name, code in re.findall(r"k(\w+) = (\d+)", enum)}
    assert codes == {"Simt": att.DESIGNS["simt"], "MmaSync": att.DESIGNS["mma.sync"],
                     "Wgmma": att.DESIGNS["wgmma"]}


@pytest.mark.parametrize("dtype,dh", [(torch.float16, 64), (torch.bfloat16, 48)])
def test_backward_design_refuses_what_no_kernel_takes(dtype, dh):
    with pytest.raises(ValueError, match="backward take"):
        att.attention_design(dtype, dh)


@pytest.mark.gpu
def test_flash_attention_kernel_matches_plain_on_card():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # ragged N (not a multiple of the 64-row tiles), N < 64, each head width
    for b, h, n, dh in [(2, 3, 1000, 64), (3, 2, 200, 16), (1, 2, 37, 32), (1, 2, 130, 128)]:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, h, n, dh), device="cuda", generator=gen).to(dt)
                       for _ in range(3))
            _build.reset_launches()
            got = flash_attention(q, k, v, dh**-0.5)
            torch.cuda.synchronize()
            assert _build.launches["flash_attention"] == 1
            assert got.shape == q.shape and got.dtype == dt
            err = _k3_error(got, flash_attention_ref(q, k, v, dh**-0.5), dt)
            assert err <= K3_TOL[dt], (b, h, n, dh, dt, err)
    # the wgmma design's ragged edges (N < 64, one past a tile, the ViT's
    # 784, 1000), with and without the lse residual of the backward
    for n in (1, 63, 65, 784, 1000):
        q, k, v = (torch.randn((2, 3, n, 64), device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        want, want_lse = flash_attention_ref(q, k, v, 0.125, return_lse=True)
        for with_lse in (False, True):
            got, lse = flash_forward(q, k, v, 0.125, with_lse=with_lse)
            torch.cuda.synchronize()
            assert _k3_error(got, want, torch.bfloat16) <= K3_TOL[torch.bfloat16], (n, with_lse)
            if with_lse:
                torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
            else:
                assert lse is None


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_heads_on_card():
    """q, k and v as the ViT hands them over: views into one (B, N, 3, H, Dh)
    qkv projection; the output lies in (B, N, H, Dh) memory."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n, h, dh = 2, 600, 6, 64
    qkv = torch.randn((b, n, 3, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got = flash_attention(q, k, v, 0.125)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    assert _k3_error(got, want, torch.bfloat16) <= K3_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    _need_card()
    for shape, dt, match in [((1, 2, 64, 48), torch.bfloat16, "Dh in"),
                             ((1, 2, 64, 64), torch.float16, "bfloat16 or")]:
        q = torch.zeros(shape, dtype=dt, device="cuda")
        with pytest.raises(ValueError, match=match):
            flash_attention(q, q, q, 0.1)
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(q, q, q, 0.1)
    q = torch.zeros((1, 2, 64, 65), dtype=torch.bfloat16, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q, 0.1)  # rows 65 elements apart


# K4/K5's tolerances, as chip_smoke.py holds them: bf16 gradients within 2 %
# of the largest |gradient| (P and dS round to bf16 before their products,
# against the kernels' and the plain version's own roundings of S and lse);
# f32 within 1e-4 (ex2.approx and another summation order).
K45_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _k45_error(got, want, wants, dtype):
    """As _k3_error, for one of the three gradients ``wants``: in bf16 the
    scale is the gradient's largest |value|, but at least 1e-3 of the
    largest |value| of any of the three, so that a gradient that is zero in
    exact arithmetic (dQ and dK at N = 1, where P = 1 and dP - di cancels) is
    held to the scale of the others, not to its own rounding noise."""
    if dtype != torch.bfloat16:
        return _k3_error(got, want, dtype)
    err = float((got.float() - want.float()).abs().max())
    top = max(float(w.float().abs().max()) for w in wants)
    return err / max(float(want.float().abs().max()), 1e-3 * top)


@pytest.mark.gpu
def test_flash_attention_backward_kernels_match_plain_on_card():
    """K4 and K5 against their plain version at the residuals K3 writes, at
    ragged N (the wgmma design at Dh 64: N = 1, 65, 300, 784, 1000), N < 64
    and each head width; K3's lse against the plain version's; two runs
    bit-identical."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(2, 3, n, 64) for n in (1, 65, 300, 784, 1000)]
    for b, h, n, dh in shapes + [(3, 2, 200, 16), (1, 2, 37, 32), (1, 2, 130, 128)]:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn((b, h, n, dh), device="cuda", generator=gen).to(dt)
                           for _ in range(4))
            scale = dh**-0.5
            out, lse = flash_forward(q, k, v, scale, with_lse=True)
            _, lse_ref = flash_attention_ref(q, k, v, scale, return_lse=True)
            torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
            _build.reset_launches()
            got = flash_attention_bwd(q, k, v, out, lse, do, scale)
            torch.cuda.synchronize()
            assert _build.launches["flash_attention_bwd_dkv"] == 1
            assert _build.launches["flash_attention_bwd_dq"] == 1
            want = flash_attention_bwd_ref(q, k, v, out, lse, do, scale)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.shape == w.shape and g.dtype == dt
                err = _k45_error(g, w, want, dt)
                assert err <= K45_TOL[dt], (b, h, n, dh, dt, name, err)
            again = flash_attention_bwd(q, k, v, out, lse, do, scale)
            assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_flash_attention_backward_di_written_by_k5_on_card():
    """The di buffer K5 writes for K4: Σ O∘dO in f32 per query row, within
    1e-5 of the largest |di| of the torch sum (another summation order of
    the same exact products), and 0 past N up to the next multiple of 64."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for b, h, n, dh, dt in [(2, 3, 300, 64, torch.bfloat16), (2, 3, 65, 16, torch.bfloat16),
                            (1, 2, 130, 128, torch.bfloat16), (2, 3, 100, 64, torch.float32)]:
        q, k, v, do = (torch.randn((b, h, n, dh), device="cuda", generator=gen).to(dt)
                       for _ in range(4))
        out, lse = flash_forward(q, k, v, dh**-0.5, with_lse=True)
        do_, o_, lse_, di = att._bwd_operands(q, k, v, out, lse, do)
        assert di.shape == (b, h, -(-n // 64) * 64) and di.dtype == torch.float32
        di.fill_(float("nan"))
        dq = torch.empty_like(q)
        att._bwd_launch(att.KERNEL_DQ, q, k, v, do_, o_, lse_, di, (dq,), dh**-0.5)
        torch.cuda.synchronize()
        want = (out.float() * do.float()).sum(-1)
        err = float((di[..., :n] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (n, dh, dt, err)
        assert bool((di[..., n:] == 0).all()), (n, dh, dt)


@pytest.mark.gpu
def test_flash_attention_autograd_reaches_the_qkv_projection_on_card():
    """Through autograd, as the ViT calls it: q, k and v are views of one
    qkv tensor that needs a gradient; K3, K4 and K5 each run once and every
    slice of qkv gets its gradient."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, n, h, dh = 2, 600, 6, 64
    qkv = torch.randn((b, n, 3, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    qkv.requires_grad_(True)
    w = torch.randn((b, h, n, dh), device="cuda", generator=gen)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    _build.reset_launches()
    out = flash_attention(q, k, v, 0.125)
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    assert {n_: _build.launches[n_] for n_ in (
        "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")} == {
        "flash_attention": 1, "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    out_ref, lse_ref = flash_attention_ref(qc, kc, vc, 0.125, return_lse=True)
    want = flash_attention_bwd_ref(qc, kc, vc, out_ref, lse_ref, w.to(torch.bfloat16), 0.125)
    for i, wg in enumerate(want):
        got = qkv.grad[:, :, i].transpose(1, 2)
        assert got.abs().max() > 0
        assert _k3_error(got, wg, torch.bfloat16) <= K45_TOL[torch.bfloat16], i


@pytest.mark.gpu
def test_gather_multi_kernel_matches_plain_on_card():
    """K1's multi-slide uint8 mode is the plain gather bit for bit, with
    lax.dynamic_slice's clamping of negative and out-of-range starts."""
    _need_card()
    rng = np.random.default_rng(4)
    bank = torch.from_numpy(rng.integers(0, 256, (3, 300, 400, 3), dtype=np.uint8)).cuda()
    for ps in (64, 57):
        coords = rng.integers(-80, 420, size=(70, 2)).astype(np.int32)
        coords[:4] = [(0, 0), (300 - ps, 400 - ps), (-1, -1), (299, 399)]
        idx = rng.integers(-1, 4, size=70).astype(np.int32)
        _build.reset_launches()
        got = gather_multi_u8(bank, idx, coords, ps)
        torch.cuda.synchronize()
        assert _build.launches["gather_multi_u8"] == 1
        assert torch.equal(got.cpu(), gather_multi_u8(bank.cpu(), idx, coords, ps))


# K1's int8 mode: (layout, bank shape, window): the exact path's raw s2d4
# windows, an odd channel count and window, PackedSlide and pack-4 tiles
# (48 channels), the fcn's s2d8 tiles, rows past 48 KB of shared memory, and
# 3-channel banks whose rows are 16-byte aligned (copied as 2-D TMA boxes,
# the odd starts inside a 16-byte chunk; the others' rows one bulk copy each)
INT8_CASES = [
    ("s2d4", (2, 700, 900, 3), 224), ("s2d4", (1, 300, 301, 5), 20),
    ("hwc", (2, 700, 900, 3), 57), ("hwc", (1, 200, 230, 48), 56),
    ("hwc", (1, 300, 300, 48), 288), ("s2d8_to_s2d4", (3, 150, 150, 192), 144),
    ("s2d8_to_s2d4", (1, 280, 280, 192), 272), ("hwc", (1, 1100, 1100, 48), 1100),
    ("s2d4", (2, 700, 912, 3), 224), ("hwc", (2, 700, 912, 3), 224),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(INT8_CASES)))
def test_gather_quantize_int8_kernel_matches_plain_on_card(case):
    """K1's int8 mode is its plain version bit for bit in every layout: odd
    starts (rows that begin inside a 16-byte chunk), clamped and negative
    starts, a window count that fills no whole wave; two runs identical."""
    _need_card()
    layout, shape, ps = INT8_CASES[case]
    s, h, w, _ = shape
    rng = np.random.default_rng(case)
    bank = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
    lut = torch.from_numpy(rng.integers(-128, 128, 256).astype(np.int8)).cuda()
    n = 37
    coords = rng.integers(-h, h + 5, size=(n, 2)).astype(np.int32)
    coords[:6] = [(0, 0), (h - ps, w - ps), (3, 1), (1, 7), (-1, -1), (h, -w - 3)]
    coords[6::2, 1] |= 1  # odd x
    idx = rng.integers(-1, s + 1, size=n).astype(np.int32)
    _build.reset_launches()
    got = gather_quantize_int8(bank, idx, coords, ps, lut, layout)
    again = gather_quantize_int8(bank, torch.from_numpy(idx).cuda(), torch.from_numpy(coords).cuda(),
                                 ps, lut, layout)
    torch.cuda.synchronize()
    assert _build.launches["gather_quantize_int8"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got, gather_quantize_int8_ref(bank, idx, coords, ps, lut, layout))


@pytest.mark.gpu
def test_gather_quantize_int8_refuses_a_table_off_the_card():
    _need_card()
    bank = torch.zeros((1, 32, 32, 3), dtype=torch.uint8, device="cuda")
    ok = (torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="lut is on"):
        gather_quantize_int8(bank, *ok, 8, torch.zeros(256, dtype=torch.int8), "hwc")


def _k2_case(name):
    """(map (dh, dw), coords in map cells, footprint, spans) of K2's card
    cases: a 16384² predict's map with patches of 224/16 or 200/16."""
    dh = dw = 1024
    rng = np.random.default_rng(len(name))
    grid = np.asarray([(y, x) for y in range(0, 16384 - 224 + 1, 112)
                       for x in range(0, 16384 - 224 + 1, 112)], np.int32)
    if name == "last rows":
        return (dh, dw), grid[-256:] // 16, 14, None
    if name == "wraps":
        c = grid[3000:3256] // 16
        c[::7] -= 1030  # some in [-dh, 0), some below
        c[1::9, 1] = -5
        return (dh, dw), c, 14, None
    if name == "spans":
        raw = np.asarray([(y, x) for y in range(0, 400, 100) for x in range(0, 16184, 100)],
                         np.int32)[:256]
        return (dh, dw), raw // 16, 13, (raw % 16 + 200) // 16
    if name == "one patch":
        return (dh, dw), np.asarray([[517, 3]], np.int32), 14, None
    if name == "2000 patches":
        return (dh, dw), rng.integers(0, 1030, (2000, 2)).astype(np.int32), 14, None
    if name == "12 channels":  # more channels than one walk sums in registers
        return (dh, dw), grid[:256] // 16, 14, None
    assert name == "one tile row"  # rows 32..45 of the map: a band inside tile row 2
    return (dh, dw), np.stack([np.full(256, 33), np.arange(256) * 4], 1).astype(np.int32), 8, None


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["last rows", "wraps", "spans", "one patch", "2000 patches",
                                  "12 channels", "one tile row"])
def test_scatter_add_map_kernel_is_the_plain_loop_bit_for_bit_on_card(name):
    """K2 over the touched band only (or the whole map when a coordinate
    wraps) adds the same f32 sums in the same order as the plain loop, and
    two runs are identical."""
    _need_card()
    (dh, dw), coords, f, spans = _k2_case(name)
    coords = torch.from_numpy(coords).cuda()
    spans = None if spans is None else torch.from_numpy(spans.astype(np.int32)).cuda()
    c = 12 if name == "12 channels" else 5
    vals = torch.randn(len(coords), c, device="cuda")
    base = torch.randn((dh, dw, c), device="cuda")  # the kernel adds to what the map holds
    runs = [scatter_add_map(base.clone(), coords, vals, f, spans) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], scatter_add_map_ref(base.clone(), coords, vals, f, spans))


# K6 cases: (x shape NHWC, Cout, kernel, stride, pads); SAME pads of flax,
# the imagenet stem's (3, 3), stride-2 (0, 1) on even extents, odd channel
# counts (the byte-wise gather) and a K of 4608 taps; then the wgmma design
# at a ragged M (3·7·7 = 147 pixels, as stage 4's 256·7·7 = 12,544 is not a
# multiple of 128), uneven stride-2 pads on odd extents, an fcn tile's
# extent (36 = 1152 / 32) and a stride-2 downsample at Cin 128
K6_CASES = [
    ((2, 17, 19, 16), 24, 3, 1, ((1, 1), (1, 1))),
    ((2, 18, 20, 32), 40, 3, 2, ((0, 1), (0, 1))),
    ((2, 17, 19, 32), 8, 3, 2, ((1, 1), (1, 1))),
    ((2, 40, 36, 3), 64, 7, 2, ((3, 3), (3, 3))),
    ((2, 16, 16, 48), 64, 2, 1, ((0, 1), (0, 1))),
    ((3, 11, 13, 20), 5, 3, 1, ((1, 1), (1, 1))),
    ((2, 14, 14, 64), 128, 1, 2, ((0, 0), (0, 0))),
    ((2, 7, 7, 512), 512, 3, 1, ((1, 1), (1, 1))),
    ((1, 9, 9, 7), 3, 2, 2, ((0, 1), (0, 1))),
    ((3, 7, 7, 256), 128, 3, 1, ((1, 1), (1, 1))),
    ((2, 9, 11, 64), 64, 3, 2, ((0, 1), (0, 1))),
    ((1, 36, 36, 64), 64, 3, 1, ((1, 1), (1, 1))),
    ((2, 14, 14, 128), 256, 1, 2, ((0, 0), (0, 0))),
]


def _k6_inputs(shape, cout, k, seed, full=False):
    """int8 x and kernel (full: every value ±127, the largest sums), and
    per-channel a, b of both signs."""
    rng = np.random.default_rng(seed)
    cin = shape[3]
    if full:
        x = rng.choice(np.array([-127, 127], np.int8), size=shape)
        w = rng.choice(np.array([-127, 127], np.int8), size=(cout, k, k, cin))
    else:
        x = rng.integers(-127, 128, shape, dtype=np.int8)
        w = rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)
    a = (rng.uniform(0.5, 2.0, cout) * 10.0 ** rng.uniform(-6, -3, cout)).astype(np.float32)
    b = rng.normal(0, 2.0, cout).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, w, a, b)]


def _np_conv_s32(x, w, stride, pads):
    """Direct numpy int64 convolution, NHWC x and (Cout, KH, KW, Cin) w."""
    (pt, pb), (pl, pr) = pads
    xp = np.pad(x.astype(np.int64), ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    cout, kh, kw, _ = w.shape
    oh = (xp.shape[1] - kh) // stride + 1
    ow = (xp.shape[2] - kw) // stride + 1
    out = np.zeros((x.shape[0], oh, ow, cout), np.int64)
    for r in range(kh):
        for c in range(kw):
            patch = xp[:, r:r + stride * (oh - 1) + 1:stride, c:c + stride * (ow - 1) + 1:stride]
            out += patch @ w[:, r, c, :].astype(np.int64).T
    return out


@pytest.mark.parametrize("case", range(len(K6_CASES)))
def test_conv_int8_ref_is_the_integer_conv_and_the_epilogue(case):
    """K6's plain version: its s32 sum is the numpy int64 convolution, and
    its epilogue is numpy's f32 product, then f32 sum (no fused multiply-add),
    relu, round half to even and clip, step by step."""
    shape, cout, k, stride, pads = K6_CASES[case]
    x, w, a, b = _k6_inputs(shape, cout, k, seed=case, full=case == 7)
    want = _np_conv_s32(x.numpy(), w.numpy(), stride, pads)
    assert np.abs(want).max() < 2**53
    got = k6.conv_s32_ref(x, w, stride, pads)
    np.testing.assert_array_equal(got.numpy(), want)
    yf = want.astype(np.float32)
    f32 = np.multiply(yf, a.numpy(), dtype=np.float32) + b.numpy()
    np.testing.assert_array_equal(k6.conv_f32(x, w, stride, pads, a, b).numpy(), f32)
    i8 = np.clip(np.rint(np.maximum(f32, 0)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(k6.conv_to_int8(x, w, stride, pads, a, b).numpy(), i8)


def test_conv_int8_refuses_what_it_does_not_take():
    x, w, a, b = _k6_inputs((1, 8, 8, 16), 8, 3, seed=0)
    pads = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="int8"):
        k6.conv_f32(x.float(), w, 1, pads, a, b)
    with pytest.raises(ValueError, match="Cin=16"):
        k6.conv_f32(x, w[..., :8], 1, pads, a, b)
    with pytest.raises(ValueError, match="float32"):
        k6.conv_f32(x, w, 1, pads, a.double(), b)
    with pytest.raises(ValueError, match="does not fit"):
        k6.conv_f32(x[:, :2, :2], w, 1, ((0, 0), (0, 0)), a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(K6_CASES)))
def test_conv_int8_kernel_matches_plain_on_card(case):
    """K6 on the card is its plain version bit for bit, in both modes, at
    odd channel counts, stride-2 edges and the largest sums; two runs are
    identical."""
    _need_card()
    shape, cout, k, stride, pads = K6_CASES[case]
    x, w, a, b = _k6_inputs(shape, cout, k, seed=case, full=case == 7)
    xc, wc, ac, bc = (t.cuda() for t in (x, w, a, b))
    for fn in (k6.conv_f32, k6.conv_to_int8):
        _build.reset_launches()
        got = fn(xc, wc, stride, pads, ac, bc)
        again = fn(xc, wc, stride, pads, ac, bc)
        torch.cuda.synchronize()
        assert _build.launches[k6.KERNEL] == 2
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), fn(x, w, stride, pads, a, b)), (case, fn.__name__)


def _block_inputs(x, w, stride, pads, a, b, res_kind, seed):
    """A residual of ``res_kind`` at the conv's output shape and the two
    scalars; next_inv puts the largest output near 127, so that the requant
    rounds everywhere and clips the tail."""
    rng = np.random.default_rng(seed)
    y = k6.conv_int8_ref(x, w, stride, pads, a, b, False)
    scale = float(y.abs().max())
    res_scale = torch.tensor(np.float32(scale / 127 / rng.uniform(1.0, 2.0)))
    next_inv = torch.tensor(np.float32(127 / scale * rng.uniform(1.0, 1.5)))
    if res_kind == "none":
        return None, res_scale, next_inv
    if res_kind == "int8":
        return torch.from_numpy(rng.integers(-127, 128, tuple(y.shape), dtype=np.int8)), \
            res_scale, next_inv
    r = torch.from_numpy((rng.normal(0, 0.5, tuple(y.shape)) * scale).astype(np.float32))
    return (r.to(torch.bfloat16) if res_kind == "bf16" else r), res_scale, next_inv


def _block_matches_plain_on_card(x, w, stride, pads, a, b, seed):
    """K6's block mode in every (residual, output) on the card vs its plain
    version: equal values (bf16 by value: -0 == +0), two runs identical,
    one launch a call."""
    dev = [t.cuda() for t in (x, w, a, b)]
    for ri, res_kind in enumerate(k6.RES_KINDS):
        residual, res_scale, next_inv = _block_inputs(x, w, stride, pads, a, b, res_kind,
                                                      seed + ri)
        for out in k6.OUT_KINDS:
            host = (residual, res_kind, res_scale, next_inv, out)
            card = tuple(t.cuda() if isinstance(t, torch.Tensor) else t for t in host)
            _build.reset_launches()
            got = k6.conv_int8_block(dev[0], dev[1], stride, pads, dev[2], dev[3], *card)
            again = k6.conv_int8_block(dev[0], dev[1], stride, pads, dev[2], dev[3], *card)
            torch.cuda.synchronize()
            assert _build.launches[k6.KERNEL] == 2
            want = k6.conv_int8_block_ref(x, w, stride, pads, a, b, *host)
            got, again, want = ((t if isinstance(t, tuple) else (t,)) for t in (got, again, want))
            for g, r, v in zip(got, again, want):
                assert g.dtype == v.dtype and torch.equal(g, r), (res_kind, out)
                assert torch.equal(g.cpu(), v), (tuple(x.shape), tuple(w.shape), res_kind, out)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(K6_CASES)))
def test_conv_int8_block_mode_matches_plain_on_card(case):
    """The fused block epilogue, in each residual kind and output, at every
    K6 case (both designs, odd Cout, ragged M, uneven pads)."""
    _need_card()
    shape, cout, k, stride, pads = K6_CASES[case]
    x, w, a, b = _k6_inputs(shape, cout, k, seed=case)
    _block_matches_plain_on_card(x, w, stride, pads, a, b, seed=100 + case)


# the wgmma design: Cin 64-512, 1x1 and 3x3, strides 1 and 2 (SAME pads)
K6_WGMMA = [(cin, k, s) for cin in (64, 128, 256, 512) for k, s in ((1, 1), (1, 2), (3, 1), (3, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("cin,k,stride", K6_WGMMA)
def test_conv_int8_wgmma_design_matches_plain_on_card(cin, k, stride):
    _need_card()
    assert k6.conv_design(cin) == "wgmma"
    shape = (2, 15, 14, cin)
    pads = tuple(same_pads(n, k, stride) for n in shape[1:3])
    cout = {64: 64, 128: 128, 256: 256, 512: 192}[cin]
    x, w, a, b = _k6_inputs(shape, cout, k, seed=cin + k + stride)
    xc, wc, ac, bc = (t.cuda() for t in (x, w, a, b))
    for fn in (k6.conv_f32, k6.conv_to_int8):
        got = fn(xc, wc, stride, pads, ac, bc)
        assert torch.equal(got.cpu(), fn(x, w, stride, pads, a, b)), fn.__name__
    _block_matches_plain_on_card(x, w, stride, pads, a, b, seed=cin)


@pytest.mark.gpu
def test_conv_int8_entry_point_refuses_unknown_codes_on_card():
    """The C entry point refuses a design with no kernel for the conv (wgmma
    at Cin 48), an unknown design, mode, residual kind or output kind, and a
    missing epilogue pointer; it launches nothing then."""
    _need_card()
    x, w, a, b = (t.cuda() for t in _k6_inputs((1, 8, 8, 48), 64, 3, seed=0))
    out = torch.empty((1, 8, 8, 64), device="cuda")
    out2 = torch.empty((1, 8, 8, 64), device="cuda", dtype=torch.int8)
    inv = torch.ones((), device="cuda")
    lib = _build.load(k6.KERNEL, k6._SIGNATURE)
    stream = torch.cuda.current_stream().cuda_stream

    def call(design, mode, res=None, res_kind=0, out_kind=2, o2=None, nxt=None, xx=x, ww=w):
        return lib.dh_conv_int8(0, xx.data_ptr(), 1, 8, 8, xx.shape[3], ww.data_ptr(), 64, 3, 3,
                                1, 1, 1, 8, 8, a.data_ptr(), b.data_ptr(), design, mode, res,
                                res_kind, None, nxt, out_kind, out.data_ptr(), o2, stream)

    assert call(1, 0) == 0  # the mma.sync design at Cin 48 runs
    assert call(2, 0) != 0  # wgmma has no kernel at Cin 48
    assert call(0, 0) != 0 and call(3, 0) != 0  # no such design
    assert call(1, 3) != 0  # no such mode
    assert call(1, 2, res_kind=4) != 0 and call(1, 2, out_kind=3) != 0
    assert call(1, 2, res_kind=1) != 0  # a residual kind without its residual
    assert call(1, 2, out_kind=1) != 0  # an int8 output without next_inv
    assert call(1, 2, out_kind=0, nxt=inv.data_ptr()) != 0  # the carry without out2
    assert call(1, 2, out_kind=0, nxt=inv.data_ptr(), o2=out2.data_ptr()) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_attention_qkv_gradient_is_the_kernels_buffer_on_card():
    """Through ``flash_attention_qkv`` the gradient of qkv equals, bit for
    bit, the gradients that ``flash_attention`` gives q, k and v taken apart,
    and it is K5/K4's buffer itself: contiguous, not a sum of copies."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, n, h, dh = 2, 600, 6, 64
    qkv = torch.randn((b, n, 3, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn((b, h, n, dh), device="cuda", generator=gen)
    a = qkv.clone().requires_grad_(True)
    (flash_attention_qkv(a, 0.125).float() * w).sum().backward()
    parts = [qkv[:, :, i].transpose(1, 2).clone().requires_grad_(True) for i in range(3)]
    (flash_attention(*parts, 0.125).float() * w).sum().backward()
    torch.cuda.synchronize()
    assert a.grad.is_contiguous()
    for i, t in enumerate(parts):
        assert torch.equal(a.grad[:, :, i].transpose(1, 2), t.grad), i


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vit", "int8_resnet"])
def test_exported_program_launches_k3_and_k6_on_card(name):
    """A tiny ViT (196 tokens: K3) and an int8 ResNet-18 (K6) exported on the
    card: the loaded program launches the kernels through the registered
    ops as often as the live model launches them directly, and gives the
    live model's logits (the int8 one bit for bit)."""
    _need_card()
    from deephisto_tpu_torch.export import Classifier, export_classifier, load_classifier
    from deephisto_tpu_torch.models import ViT, quantize_resnet
    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if name == "vit":
        model, ps, kernel = ViT(5, patch=4, dim=64, depth=2, heads=1, img_size=56), 56, att.KERNEL
        model = init_model(model, seed=0).to(dev)
        dtype = torch.bfloat16
    else:
        ps, kernel, dtype = 32, k6.KERNEL, torch.float32
        float_model = init_model(get_model(3, depth=18, stem="s2d", dtype=torch.float32), seed=1)
        model = quantize_resnet(float_model.to(dev), [torch.rand(4, ps, ps, 3, generator=gen)])
    x = torch.randint(0, 256, (4, ps, ps, 3), dtype=torch.uint8, generator=gen).to(dev)
    fn = load_classifier(export_classifier(model, 4, ps, dtype=dtype, device=dev))
    with torch.no_grad():
        _build.reset_launches()
        want = Classifier(model, dtype)(x)
        live = _build.launches.get(kernel, 0)
        _build.reset_launches()
        got = fn(x)
        loaded = _build.launches.get(kernel, 0)
    assert live > 0 and loaded == live, (live, loaded)
    if name == "vit":
        torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
    else:
        assert torch.equal(got, want)
