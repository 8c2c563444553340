"""The port's kernels against their plain PyTorch versions, and the plain
versions against numpy loops. This file imports no JAX, so it also runs on
the machine with the card: ``python -m pytest -m gpu tests/test_torch_kernels.py``.
The ``gpu`` tests decide in their body whether a card is present and skip
without one."""

import numpy as np
import pytest
import torch

from deephisto_tpu_torch import _build
from deephisto_tpu_torch.ops import (
    flash_attention,
    flash_attention_ref,
    gather_normalize,
    gather_normalize_ref,
    scatter_add_map,
    scatter_add_map_exact,
    scatter_add_map_ref,
)


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
    got = scatter_add_map_ref(torch.zeros(dh, dw, c), coords, torch.from_numpy(vals), f)
    want = np.zeros((dh + 2 * f, dw + 2 * f, c), np.float32)  # margin catches drops
    for (y, x), v in zip(coords, vals):
        want[y + f : y + 2 * f, x + f : x + 2 * f] += v
    np.testing.assert_array_equal(got.numpy(), want[f : f + dh, f : f + dw])


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
    with pytest.raises(ValueError, match="out of range"):
        gather_normalize(img, torch.tensor([[1024 - 223, 0]], dtype=torch.int32).cuda(), 224)


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
    one = scatter_add_map(
        torch.zeros((4, 4, 1), device="cuda"),
        torch.tensor([[-1, -1], [3, 3]], dtype=torch.int32), torch.ones(2, device="cuda"), 2,
    )
    want = torch.zeros((4, 4, 1))
    want[0, 0] = want[3, 3] = 1.0
    assert torch.equal(one.cpu(), want)


# K3's tolerances, as chip_smoke.py holds them: bf16 outputs within 1 % of the
# largest |output| (P and the output each round to bf16, against other maxima
# than the plain version's); f32 within 1e-4 (ex2.approx and another
# summation order than the f32 matmuls of the plain version).
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _k3_error(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    return err / float(want.float().abs().max()) if dtype == torch.bfloat16 else err


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
