"""Smoke test of the PyTorch + CUDA port (``deephisto_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
of JAX or of the JAX package. Phases, any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every kernel under ``deephisto_tpu_torch/csrc`` with ``nvcc``;
3. kernels vs their plain PyTorch versions on the card at the main path's
   shapes: K1 (gather + /255) bit-equal in f32 and bf16, K2 (stitch) within
   1e-5 of the sequential loop and identical from run to run; each timed with
   CUDA events beside its byte bound and, for K2, the library call;
4. main path: ``predict_full_fused`` on a seeded 16384² uint8 slide with a
   seeded full-width bf16 ResNet-18 (5 classes, batch 256): one warm-up run,
   then the best of 3; patches/s, peak memory, and the launch counts of both
   kernels over those runs (both must be > 0);
5. the main path vs the same model through the plain gather and stitch on a
   4096² crop: argmax agreement and the largest score difference.

6. profile: one main-path predict under ``torch.profiler``: device time by
   kernel group, the largest kernels, and the card's busy share;
7. ViT main path: ``predict_full_fused`` on a seeded 8192² crop of the slide
   (5,329 patches, 21 batches of 256) with a seeded full-width ``vit2p8``
   ViT (``get_model(5, arch="vit", depth=6, stem="conv", patch=8)``: dim
   384, 6 heads, 784 tokens a patch; random BN statistics, centred head),
   bf16: one warm-up, then the best of 3; patches/s, peak memory, and K3
   launched exactly depth × batches = 126 times a predict;
8. the ViT path vs the same model with the plain attention on a 2048² crop:
   argmax agreement and the largest score difference;
9. profile of one ViT predict, by kernel group;
10. training main path: the port's synthetic dataset (3 train slides of
    3072², hard, seed 7, as benchmarks/time_to_accuracy.py), the region
    sampler (patch 224, layer 2, 4 patches a region, one image a batch), a
    seeded full-width ``vit2p8`` in bf16, AdamW (lr 3e-4, wd 0.05),
    ``crop_pad`` 16, label smoothing 0.1, batch 256, through
    ``make_fused_epoch``: one untimed epoch, then timed epochs; steps/s,
    patches/s, peak memory, finite losses, and the launches a step (K1's
    multi-slide mode 1, K3, K4 and K5 6 each);
11. one vit2p8 train step vs the same step with the plain attention (loss
    and every parameter's gradient), and 8 steps on one batch that must
    lower its loss;
12. ResNet-18 (s2d stem, Adam lr 1e-3) training through the same epoch:
    finite losses, BatchNorm running statistics moved, steps/s;
13. profile of one vit2p8 train step, by kernel group.

Phase 3 also holds K3 (flash attention) against its plain version in bf16
and f32 at the ViT's shape (256, 6, 784, 64), a ragged N = 1000, N = 196
and Dh 16 and 32, times it beside its FLOP bound, its plain version and
``F.scaled_dot_product_attention`` (a yardstick only: the port never calls
it), and times K3, the plain jnp-branch attention and SDPA at 196 and 784
tokens; K4 and K5 (the flash-attention backward) against their plain
version at the training shape, a ragged one, Dh 16/32/128 and f32, two runs
bit-identical, timed beside their bounds, the plain version and SDPA's
backward; and K1's multi-slide uint8 mode bit-equal to its plain version at
the training bank's shape.

It prints the card line, then one ``{"kernels": [...]}`` line, then as its
last line ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
MAIN_SIDE, CHECK_SIDE = 16384, 4096
VIT_SIDE, VIT_CHECK_SIDE, VIT_DEPTH, VIT_PATCH = 8192, 2048, 6, 8
PS, STRIDE, D, BS, N_CLASSES = 224, 112, 16, 256, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense tensor-core peak, H100 SXM data sheet
K2_TOL = 1e-5  # both sides add in patch order; f32 sums of the same terms
# K3 vs its plain version: bf16 within 1 % of the largest |output| (P and the
# output round to bf16 against other running maxima than the plain version's);
# f32 within 1e-4 absolute (ex2.approx and another summation order)
K3_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the ViT path vs the same model with the plain attention (phase 8): that
# path rounds Q·Kᵀ and its scaling to bf16 where K3 keeps f32, so logits move
# at bf16 scale through 6 blocks; a class flips only on a near tie
VIT_AGREE, VIT_DIFF = 0.99, 2e-2
K3_SHAPES = [(256, 6, 784, 64), (8, 6, 1000, 64), (256, 6, 196, 64),
             (16, 6, 300, 16), (16, 6, 300, 32)]
# K4/K5 vs their plain version: bf16 gradients within 2 % of the largest
# |gradient| (P and dS round to bf16 before their products against the
# kernels' and the plain version's own roundings of S); f32 within 1e-4
K45_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
K45_SHAPES = [(256, 6, 784, 64), (8, 6, 1000, 64), (16, 6, 300, 16), (16, 6, 300, 32),
              (8, 6, 300, 128)]
# training (phases 10-13): the vit2p8 recipe of benchmarks/time_to_accuracy.py
TRAIN_SIDE, TRAIN_LAYER, TRAIN_CROP, TRAIN_STEPS, TRAIN_EPOCHS = 3072, 2, 16, 10, 2
# the vit2p8 step vs the same step with the plain attention (bf16 Q·Kᵀ
# there): per parameter tensor ||g - g'|| / ||g'||, and the loss
GRAD_REL, LOSS_DIFF = 2e-2, 1e-2
MAIN_TIMED_RUNS = 3
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's 1.98 GHz boost clock


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, by CUDA events. A spin
    kernel ahead of the start event keeps the card busy while the host
    queues the calls, so a short kernel is timed back to back and not at the
    host's pace (a call that waits for the card, as the plain K2 loop does,
    is timed with its waits)."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seeded_model(device, **kwargs):
    """``get_model(N_CLASSES, **kwargs)`` in bf16 with seeded weights and
    random BN statistics, so that no conv path is constant."""
    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model

    model = init_model(get_model(N_CLASSES, dtype=torch.bfloat16, **kwargs), seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return model.to(device).eval()


@torch.no_grad()
def center_head(model, head, slide, coords) -> None:
    """Shift the bias of the ``head`` Linear so that the logits are centred
    over patches spread across the slide: a random trunk's pooled features
    share a large common part, and without this one class would win every
    patch. The head's input is caught with a forward pre-hook."""
    from deephisto_tpu_torch.ops import gather_normalize

    feats = []
    hook = head.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    try:
        model(gather_normalize(slide, coords, PS, torch.bfloat16))
    finally:
        hook.remove()
    head.bias -= head.weight @ feats[0].float().mean(0)


def seeded_slide(device):
    """Uniform noise over a 16×16 grid of random block colours, made on the
    card: the blocks give the class map structure to agree on."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    noise = torch.randint(0, 128, (MAIN_SIDE, MAIN_SIDE, 3), dtype=torch.uint8,
                          device=device, generator=gen)
    blocks = torch.randint(0, 128, (16, 16, 3), dtype=torch.uint8, device=device, generator=gen)
    rep = MAIN_SIDE // 16
    return noise + blocks.repeat_interleave(rep, 0).repeat_interleave(rep, 1)


def covered_pixels(coords: np.ndarray, ps: int) -> int:
    """Slide pixels under the union of the ps×ps patches at (N, 2) (y, x)."""
    lo = coords.min(0)
    mask = np.zeros(tuple(coords.max(0) - lo + ps), dtype=bool)
    for y, x in coords - lo:
        mask[y:y + ps, x:x + ps] = True
    return int(mask.sum())


def check_k1(slide, dense):
    from deephisto_tpu_torch.ops import gather_normalize, gather_normalize_ref

    h, w = slide.shape[:2]
    rng = np.random.default_rng(SEED)
    edge = [(0, 0), (h - PS, w - PS), (h - PS, 1), (3, w - PS), (h - PS, w // 4 + 1), (h // 16 + 1, 3)]
    rand = rng.integers(0, [h - PS + 1, w - PS + 1], size=(BS - len(edge), 2))
    rand[::2, 1] |= 1  # odd x: unaligned rows
    coords = torch.from_numpy(np.concatenate([edge, rand]).astype(np.int32))
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = gather_normalize(slide, coords, PS, dt)
        torch.cuda.synchronize()
        want = gather_normalize_ref(slide, coords, PS, dt)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {dt} differs from its plain version")
        err = max(err, float((got.float() - want.float()).abs().max()))
    print(f"K1 gather_normalize: bit-equal to the plain version in f32 and bf16 "
          f"at N={BS}, ps={PS} on a {h}x{w} slide")

    # timed on 16 distinct main-path batches in turn, so a call does not find
    # its slide rows in L2 from the call before
    batches = [dense[i * BS:(i + 1) * BS] for i in range(16)]
    ms = cuda_ms(lambda i: gather_normalize(slide, batches[i % 16], PS, torch.bfloat16), 32)
    plain_ms = cuda_ms(
        lambda i: gather_normalize_ref(slide, batches[i % 16], PS, torch.bfloat16), 8
    )
    # bytes a call must move: the slide bytes under the union of its patches
    # (stride-112 patches overlap by half on both axes), the bf16 patches, the
    # coords and the table; averaged over the batches timed
    nbytes = np.mean([
        covered_pixels(b.numpy(), PS) * 3 + BS * PS * PS * 3 * 2 + BS * 8 + 256 * 2
        for b in batches
    ])
    return {
        "name": "gather_normalize", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/gather.cu",
        "replaces": "deephisto_tpu/experimental/pallas_gather.py:152",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }


def check_k2(dense, device):
    from deephisto_tpu_torch.ops import scatter_add_map, scatter_add_map_ref

    dh = dw = MAIN_SIDE // D
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 2)
    dense200 = torch.from_numpy(
        np.asarray([(y, x) for y in range(0, 4 * 100, 100) for x in range(0, MAIN_SIDE - 200, 100)],
                   dtype=np.int32)[:BS]
    )
    off_map = rng.integers(0, MAIN_SIDE + 2 * PS, size=(BS, 2)).astype(np.int32)
    cases = {  # name: (raw coords, ps) with d = 16
        "dense 224/16": (dense[:BS], 224),
        "random, some off the map, 224/16": (torch.from_numpy(off_map), 224),
        "dense 200/16 (spans)": (dense200, 200),
        "random, some off the map, 200/16 (spans)": (torch.from_numpy(off_map), 200),
    }
    err = 0.0
    for name, (raw, ps) in cases.items():
        raw = raw.to(device)
        vals = torch.randn((len(raw), N_CLASSES), device=device, generator=gen)
        f = ps // D if ps % D == 0 else ps // D + 1
        spans = None if ps % D == 0 else (raw % D + ps) // D
        runs = [
            scatter_add_map(torch.zeros((dh, dw, N_CLASSES), device=device), raw // D, vals, f, spans)
            for _ in range(2)
        ]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"K2 is not deterministic ({name})")
        want = scatter_add_map_ref(torch.zeros_like(runs[0]), raw // D, vals, f, spans)
        e = float((runs[0] - want).abs().max())
        if e > K2_TOL:
            raise AssertionError(f"K2 differs from its plain version by {e} ({name})")
        err = max(err, e)
        print(f"K2 scatter_add_map [{name}]: max |diff| {e} (tolerance {K2_TOL}), "
              "two runs bit-identical")

    # timing: one main-path batch (the first 256 tiles of the dense grid)
    cds = (dense[:BS] // D).to(device)
    vals = torch.randn((BS, N_CLASSES), device=device, generator=gen)
    acc = torch.zeros((dh, dw, N_CLASSES), device=device)
    f = PS // D
    ms = cuda_ms(lambda i: scatter_add_map(acc, cds, vals, f), 50)
    plain_ms = cuda_ms(lambda i: scatter_add_map_ref(acc, cds, vals, f), 5)
    off = torch.arange(f, device=device)
    yy = (cds[:, 0, None, None] + off[None, :, None]).expand(BS, f, f).reshape(-1).long()
    xx = (cds[:, 1, None, None] + off[None, None, :]).expand(BS, f, f).reshape(-1).long()
    vv = vals[:, None, :].expand(BS, f * f, N_CLASSES).reshape(-1, N_CLASSES)
    library_ms = cuda_ms(lambda i: acc.index_put_((yy, xx), vv, accumulate=True), 50)
    c = dense[:BS].numpy() // D
    cells = {(y + a, x + b) for y, x in c for a in range(f) for b in range(f)
             if y + a < dh and x + b < dw}
    nbytes = BS * N_CLASSES * 4 + BS * 8 + 2 * len(cells) * N_CLASSES * 4
    return {
        "name": "scatter_add_map", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/stitch.cu",
        "replaces": "deephisto_tpu/ops/stitch.py:107",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def check_k3(device):
    from deephisto_tpu_torch.ops import attention_plain, flash_attention, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    err = 0.0
    for shape in K3_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, device=device, generator=gen).to(dt) for _ in range(3))
            got = flash_attention(q, k, v, shape[-1] ** -0.5)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, shape[-1] ** -0.5).float()
            e = float((got.float() - want).abs().max())
            rel = e / float(want.abs().max())
            measure = rel if dt == torch.bfloat16 else e
            print(f"K3 flash_attention {shape} {str(dt)[6:]}: max |diff| {e} "
                  f"(relative {rel}; tolerance {K3_TOL[dt]} "
                  f"{'relative' if dt == torch.bfloat16 else 'absolute'})")
            if not measure <= K3_TOL[dt]:
                raise AssertionError(f"K3 differs from its plain version at {shape} {dt}")
            if dt == torch.bfloat16:
                err = max(err, e)
            del q, k, v, got, want

    def qkv(b, n):
        return [torch.randn((b, 6, n, 64), device=device, generator=gen).to(torch.bfloat16)
                for _ in range(3)]

    # the main shape; then K3, the plain jnp branch and SDPA at 196 and 784
    # tokens (the JAX model's FLASH_MIN_SEQ = 512 sits between them)
    F = torch.nn.functional
    b, h, n, dh = K3_SHAPES[0]
    q, k, v = qkv(b, n)
    ms = cuda_ms(lambda i: flash_attention(q, k, v, dh ** -0.5), 20)
    plain_ms = cuda_ms(lambda i: flash_attention_ref(q, k, v, dh ** -0.5), 3)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(q, k, v, scale=dh ** -0.5), 20)
    flops = 4 * b * h * n * n * dh
    nbytes = 4 * b * h * n * dh * 2
    seq = {}
    for n_tok in (196, 784):
        q2, k2, v2 = qkv(b, n_tok)
        seq[n_tok] = {
            "flash_attention_ms": cuda_ms(lambda i: flash_attention(q2, k2, v2, 0.125), 20),
            "attention_plain_ms": cuda_ms(lambda i: attention_plain(q2, k2, v2), 10),
            "sdpa_ms": cuda_ms(
                lambda i: F.scaled_dot_product_attention(q2, k2, v2, scale=0.125), 20),
        }
    print(f"K3 at ({b}, {h}, N, {dh}) bf16 by tokens N (ms): " + json.dumps(seq))
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/attention.cu",
        "replaces": "deephisto_tpu/models/vit.py:125 (jax.experimental.pallas.ops.tpu."
                    "flash_attention, flash_attention.py:131)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": library_ms, "tflops": flops / ms / 1e9, "by_tokens": seq,
    }


def check_k1_multi(device):
    """K1's multi-slide uint8 mode at the training bank's shape: 3 slides of
    1536² (3072² at layer 2) plus the bank's slack, 256 windows of
    224 + 2·16 px, bit-equal to the plain gather (starts clamped as
    lax.dynamic_slice does, some out of range)."""
    from deephisto_tpu_torch.ops import gather_multi_u8, gather_patches_multi
    from deephisto_tpu_torch.samplers.bank import SLACK_COLS, SLACK_ROWS

    side = TRAIN_SIDE // TRAIN_LAYER
    shape = (3, side + SLACK_ROWS, side + SLACK_COLS, 3)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    bank = torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)
    win = PS + 2 * TRAIN_CROP
    rng = np.random.default_rng(SEED + 5)
    batches = []
    for _ in range(8):
        idx = rng.integers(0, 3, BS).astype(np.int32)
        coords = rng.integers(0, side - win + 1, (BS, 2)).astype(np.int32)
        batches.append((torch.from_numpy(idx).to(device), torch.from_numpy(coords).to(device)))
    idx, coords = (t.clone() for t in batches[0])
    idx[:2] = torch.tensor([-1, 5])
    coords[:3] = torch.tensor([[-7, 3], [shape[1], shape[2]], [side - win, side - win]])
    got = gather_multi_u8(bank, idx, coords, win)
    torch.cuda.synchronize()
    if not torch.equal(got, gather_patches_multi(bank, idx, coords, win)):
        raise AssertionError("K1's multi-slide mode differs from its plain version")
    print(f"K1 gather_multi_u8: bit-equal to the plain gather at N={BS}, window {win}, "
          f"bank {shape}")
    ms = cuda_ms(lambda i: gather_multi_u8(bank, *batches[i % 8], win), 40)
    plain_ms = cuda_ms(lambda i: gather_patches_multi(bank, *batches[i % 8], win), 10)
    nbytes = 2 * BS * win * win * 3 + BS * 12
    return {
        "name": "gather_multi_u8", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/gather.cu",
        "replaces": "deephisto_tpu/experimental/pallas_gather.py:152 (multi-slide u8 mode; "
                    "the path's gather_patches_multi_xla, deephisto_tpu/ops/gather.py:59)",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
    }


def check_k45(device):
    """K4 (dK, dV) and K5 (dQ) against their plain version at the residuals
    K3 writes; two runs bit-identical; times at the training shape."""
    from deephisto_tpu_torch.ops import flash_attention_bwd, flash_attention_bwd_ref
    from deephisto_tpu_torch.ops import attention as att

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    err = {att.KERNEL_DKV: 0.0, att.KERNEL_DQ: 0.0}
    for shape in K45_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and shape[0] == 256:
                continue  # the SIMT f32 path at the training shape: minutes, no news
            q, k, v, do = (torch.randn(shape, device=device, generator=gen).to(dt)
                           for _ in range(4))
            scale = shape[-1] ** -0.5
            out, lse = att._forward(q, k, v, scale, with_lse=True)
            got = flash_attention_bwd(q, k, v, out, lse, do, scale)
            again = flash_attention_bwd(q, k, v, out, lse, do, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K4/K5 are not deterministic at {shape} {dt}")
            want = flash_attention_bwd_ref(q, k, v, out, lse, do, scale)
            parts = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                e = float((g.float() - w.float()).abs().max())
                rel = e / float(w.float().abs().max())
                measure = rel if dt == torch.bfloat16 else e
                parts.append(f"{name} {e:.3g} ({rel:.3g} rel)")
                if not measure <= K45_TOL[dt]:
                    raise AssertionError(f"{name} differs from its plain version at {shape} {dt}")
                if dt == torch.bfloat16:
                    kern = att.KERNEL_DQ if name == "dq" else att.KERNEL_DKV
                    err[kern] = max(err[kern], e)
            print(f"K4/K5 flash_attention_bwd {shape} {str(dt)[6:]}: max |diff| "
                  f"{', '.join(parts)}; tolerance {K45_TOL[dt]} "
                  f"{'relative' if dt == torch.bfloat16 else 'absolute'}; two runs bit-identical")
            del q, k, v, do, out, lse, got, again, want

    F = torch.nn.functional
    b, h, n, dh = K45_SHAPES[0]
    scale = dh ** -0.5
    q, k, v, do = (torch.randn((b, h, n, dh), device=device, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = att._forward(q, k, v, scale, with_lse=True)
    do_, lse_, di = att._bwd_operands(q, k, v, out, lse, do)
    grads = torch.empty((b, n, 3, h, dh), dtype=q.dtype, device=device)
    dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
    dkv_ms = cuda_ms(lambda i: att._bwd_launch(att.KERNEL_DKV, q, k, v, do_, lse_, di, (dk, dv),
                                               scale), 20)
    dq_ms = cuda_ms(lambda i: att._bwd_launch(att.KERNEL_DQ, q, k, v, do_, lse_, di, (dq,),
                                              scale), 20)
    bwd_ms = cuda_ms(lambda i: flash_attention_bwd(q, k, v, out, lse, do, scale), 20)
    plain_ms = cuda_ms(lambda i: flash_attention_bwd_ref(q, k, v, out, lse, do, scale), 3)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    sdpa_bwd_ms = cuda_ms(lambda i: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                                        retain_graph=True), 20)
    prod = 2 * b * h * n * n * dh  # one N×N×Dh product
    whole_bound = 5 * prod / BF16_FLOP_PER_S * 1e3
    print(f"K4+K5 at ({b}, {h}, {n}, {dh}) bf16: K4 {dkv_ms:.4f} ms, K5 {dq_ms:.4f} ms, the "
          f"backward (di, K4, K5) {bwd_ms:.4f} ms = {5 * prod / bwd_ms / 1e9:.1f} TFLOP/s of "
          f"the 5-product bound {whole_bound:.4f} ms; plain {plain_ms:.3f} ms; SDPA backward "
          f"{sdpa_bwd_ms:.4f} ms")
    common = {"route": "cuda", "source": "deephisto_tpu_torch/csrc/attention_bwd.cu",
              "plain_ms": plain_ms, "library_ms": sdpa_bwd_ms, "bound_by": "operations",
              "backward_ms": bwd_ms, "backward_bound_ms": whole_bound}
    # each kernel's bound: the products its function needs from its inputs
    # (K4: S, dP, dV, dK; K5: S, dP, dQ)
    return [
        dict(common, name=att.KERNEL_DKV, max_abs_err=err[att.KERNEL_DKV], ms=dkv_ms,
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                      "(_flash_attention_bwd_dkv), from deephisto_tpu/models/vit.py:125,130",
             bound_ms=4 * prod / BF16_FLOP_PER_S * 1e3, tflops=4 * prod / dkv_ms / 1e9),
        dict(common, name=att.KERNEL_DQ, max_abs_err=err[att.KERNEL_DQ], ms=dq_ms,
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                      "(_flash_attention_bwd_dq), from deephisto_tpu/models/vit.py:125,130",
             bound_ms=3 * prod / BF16_FLOP_PER_S * 1e3, tflops=3 * prod / dq_ms / 1e9),
    ]


def run_main_path(slide, model, side, label):
    """One warm-up predict, then the best of ``MAIN_TIMED_RUNS``, with every
    launch count set to 0 just before and read just after. Checks the maps
    and returns (launches, runs, best seconds, peak GiB, argmax map)."""
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.predict import predict_full_fused

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    argmax_map, score_map = predict_full_fused(slide, model, N_CLASSES)
    warm_s = time.perf_counter() - t0
    best_s = float("inf")
    for _ in range(MAIN_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        argmax_map, score_map = predict_full_fused(slide, model, N_CLASSES)
        torch.cuda.synchronize()
        best_s = min(best_s, time.perf_counter() - t0)
    launches = dict(_build.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if argmax_map.shape != (side // D,) * 2 or argmax_map.dtype != np.uint8:
        raise AssertionError(f"{label}: argmax map {argmax_map.shape} {argmax_map.dtype}")
    if int(argmax_map.max()) >= N_CLASSES:
        raise AssertionError(f"{label}: argmax map holds a class id >= n_classes")
    if score_map.shape != (side // D, side // D, N_CLASSES):
        raise AssertionError(f"{label}: score map {tuple(score_map.shape)}")
    if not bool(torch.isfinite(score_map).all()):
        raise AssertionError(f"{label}: score map is not finite")
    return launches, 1 + MAIN_TIMED_RUNS, warm_s, best_s, peak_gib, argmax_map


def plain_predict(image, model):
    """The exact dense predict through the plain gather and stitch."""
    from deephisto_tpu_torch.ops import gather_patches, scatter_add_map_ref
    from deephisto_tpu_torch.predict import dense_coords, model_input

    h, w = image.shape[:2]
    coords = dense_coords(h, w, PS, STRIDE)
    n = len(coords)
    n_b = -(-n // BS)
    coords = torch.from_numpy(np.concatenate([coords, np.repeat(coords[-1:], n_b * BS - n, 0)]))
    score = torch.zeros((h // D, w // D, N_CLASSES), device=image.device)
    with torch.inference_mode():
        for b in range(n_b):
            cb = coords[b * BS:(b + 1) * BS].to(image.device)
            logits = model(model_input(model, gather_patches(image, cb, PS)))
            real = min(BS, n - b * BS)
            scatter_add_map_ref(score, cb[:real] // D, logits[:real], PS // D)
    return score.argmax(-1).to(torch.uint8).cpu().numpy(), score


KERNEL_GROUPS = (  # lower-case kernel-name substring -> group, first match wins
    ("gather_normalize", "K1 gather_normalize"), ("scatter_add_map", "K2 scatter_add_map"),
    ("gather_multi_u8", "K1 gather_multi_u8"), ("flash_fwd", "K3 flash_attention"),
    ("flash_bwd_dkv", "K4 flash_attention_bwd_dkv"), ("flash_bwd_dq", "K5 flash_attention_bwd_dq"),
    ("adam", "optimizer"), ("layer_norm", "LayerNorm"), ("gelu", "GELU"),
    ("batch_norm", "batch norm"), ("addpadding", "cuDNN input padding"),
    ("fprop", "convolution"), ("conv", "convolution"), ("max_pool", "max pool"),
    ("gemm", "GEMM (Dense)"), ("nvjet", "GEMM (Dense)"), ("cutlass", "GEMM (Dense)"),
    ("dgrad", "convolution backward"), ("wgrad", "convolution backward"),
    ("xmma", "GEMM (Dense)"), ("clamp", "relu"), ("copy", "dtype casts / copies"),
    ("add", "residual / bias add"), ("reduce", "mean / argmax"), ("fill", "fill / memset"),
    ("memset", "fill / memset"),
)


def profile_main_path(slide, model) -> dict:
    """Device time of one predict by kernel group, and the card's busy share."""
    from deephisto_tpu_torch.predict import predict_full_fused

    return profile_device(lambda: predict_full_fused(slide, model, N_CLASSES))


def profile_device(fn) -> dict:
    """Device time of ``fn()`` by kernel group, and the card's busy share
    (union of kernel intervals over the profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, names = [], {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        spans.append((start, start + dur))
        group = next((g for k, g in KERNEL_GROUPS if k in e.name.lower()), "other")
        groups[group] = groups.get(group, 0.0) + dur
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + dur
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kernel_us = sum(groups.values())
    return {
        "wall_ms": wall_us / 1e3, "device_busy_share": busy / wall_us,
        "kernel_ms": kernel_us / 1e3,
        "groups_ms": {g: v / 1e3 for g, v in sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels_ms": {n: v / 1e3 for n, v in sorted(names.items(), key=lambda x: -x[1])[:12]},
    }


def train_pairs(root):
    """The training slides of the port's synthetic dataset, made in ``root``
    as benchmarks/time_to_accuracy.py makes its own (3 train + 1 test slides
    of 3072², hard regime, seed 7). Returns (pairs, seconds)."""
    from deephisto_tpu_torch.data import ensure_synthetic_dataset
    from deephisto_tpu_torch.utils import get_img_ano_paths

    t0 = time.perf_counter()
    ds = ensure_synthetic_dataset(Path(root) / "synthetic_hard", n_train=3, n_test=1,
                                  height=TRAIN_SIDE, width=TRAIN_SIDE, hard=True, seed=7)
    return get_img_ano_paths(ds, "train"), time.perf_counter() - t0


def run_training(label, model, sampler, lr, wd, crop_pad, smoothing):
    """One untimed epoch of ``TRAIN_STEPS`` steps, then ``TRAIN_EPOCHS``
    timed ones with every launch count set to 0 just before and read just
    after. Returns (state, launches a step, seconds a step, peak GiB,
    losses)."""
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.models.patch_cls_simple import make_fused_epoch
    from deephisto_tpu_torch.train import create_train_state

    state = create_train_state(model, lr, weight_decay=wd)
    epoch = make_fused_epoch(model, sampler, BS, TRAIN_STEPS, crop_pad=crop_pad,
                             label_smoothing=smoothing)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    state, first, _ = epoch(state, gen)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses = [first]
    for _ in range(TRAIN_EPOCHS):
        state, l, c = epoch(state, gen)  # returns after its one read back
        losses.append(l)
    secs = (time.perf_counter() - t0) / (TRAIN_EPOCHS * TRAIN_STEPS)
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    per_step = {k: v / steps for k, v in _build.launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.cat(losses)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: a training loss is not finite: {losses.tolist()}")
    print(f"{label} training: batch {BS}, {TRAIN_EPOCHS} timed epochs of {TRAIN_STEPS} steps "
          f"after an untimed one ({warm_s:.2f} s): {secs * 1e3:.2f} ms a step = "
          f"{1 / secs:.3f} steps/s = {BS / secs:.1f} patches/s; peak memory {peak:.2f} GiB; "
          f"launches a step {per_step}; losses by step {[round(x, 4) for x in losses.tolist()]}")
    return state, per_step, secs, peak, losses


def vit_step_vs_plain(model, sampler, device):
    """One train-mode loss and gradient of ``model`` on one sampled batch
    with K3-K5, and with the plain attention (FLASH_MIN_SEQ raised), from
    copies of the same weights; then 8 optimizer steps on that batch."""
    import copy

    from deephisto_tpu_torch.models import vit as vit_module
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.train import create_train_state, cross_entropy_loss

    n = 64  # the plain attention keeps (B, H, N, N) scores for its backward
    patches, labels, _, _ = sampler.make_sample_fn(n)(
        torch.Generator(device).manual_seed(SEED + 7))
    x = patches.float() / 255.0

    def loss_and_grads():
        m = copy.deepcopy(model).train()
        loss = cross_entropy_loss(m(x), labels, 0.1)
        names, params = zip(*m.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))

    loss, grads = loss_and_grads()
    flash_min = vit_module.FLASH_MIN_SEQ
    vit_module.FLASH_MIN_SEQ = 1 << 30
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        vit_module.FLASH_MIN_SEQ = flash_min
    rel = {}
    for name, g in grads.items():
        ref = grads_p[name].float()
        denom = float(ref.norm())
        rel[name] = float((g.float() - ref).norm()) / (denom if denom > 0 else 1.0)
    worst = max(rel, key=rel.get)
    dloss = abs(float(loss) - float(loss_p))
    print(f"vit2p8 train step with K3-K5 vs the plain attention (batch {n}): loss "
          f"{float(loss):.6f} vs {float(loss_p):.6f} (|diff| {dloss:.3g}, bound {LOSS_DIFF}); "
          f"per-tensor ||g - g'||/||g'|| max {rel[worst]:.3g} at {worst} (bound {GRAD_REL}), "
          f"median {float(np.median(list(rel.values()))):.3g} over {len(rel)} tensors")
    if dloss > LOSS_DIFF or rel[worst] > GRAD_REL:
        raise AssertionError("the vit2p8 step with K3-K5 disagrees with the plain attention")

    m = copy.deepcopy(model)
    state = create_train_state(m, 3e-4, weight_decay=0.05)
    train_step, _ = make_steps(m)
    losses = []
    for _ in range(8):
        state, l, _ = train_step(state, x, labels)
        losses.append(l)
    losses = torch.stack(losses).tolist()
    print(f"vit2p8 overfit of one batch of {n}: losses over 8 steps {[round(v, 4) for v in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError("8 steps on one batch did not lower its loss")
    return {"loss_diff": dloss, "worst_grad_rel": rel[worst], "worst_tensor": worst,
            "overfit_losses": losses}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.predict import dense_coords, predict_full_fused

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    device = torch.device("cuda", 0)
    # the f32 plain versions run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    secs = _build.build()
    print(f"build: {', '.join(s + '.cu' for s in _build.SOURCES)} with nvcc for sm_90a "
          f"in {secs:.1f} s")

    # 3. kernels vs plain at the main path's shapes
    slide = seeded_slide(device)
    dense = torch.from_numpy(dense_coords(MAIN_SIDE, MAIN_SIDE, PS, STRIDE))
    kernels = [check_k1(slide, dense), check_k1_multi(device), check_k2(dense, device),
               check_k3(device), *check_k45(device)]
    for k in kernels:
        k["launches"] = 0
        k["launches_by_path"] = {}

    # 4. main path
    model = seeded_model(device, depth=18)
    n_patches = len(dense)
    center_head(model, model.fc, slide, dense[:: n_patches // 64][:64])
    launches, runs, warm_s, best_s, peak_gib, argmax_map = run_main_path(
        slide, model, MAIN_SIDE, "ResNet-18 path")
    for name in ("gather_normalize", "scatter_add_map"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"the main path never launched {name}")
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
        k["launches_by_path"]["resnet18_16384"] = launches.get(k["name"], 0) / runs
    print(f"main path: {MAIN_SIDE}x{MAIN_SIDE} slide, {n_patches} patches, ResNet-18 bf16, "
          f"batch {BS}: warm-up {warm_s:.3f} s, best of {MAIN_TIMED_RUNS} {best_s:.4f} s = "
          f"{n_patches / best_s:.1f} patches/s; peak memory {peak_gib:.2f} GiB; launches "
          f"over {runs} runs: {launches}; classes present "
          f"{np.bincount(argmax_map.ravel(), minlength=N_CLASSES).tolist()}")

    # 5. main path vs the plain composition on a crop
    crop = slide[:CHECK_SIDE, :CHECK_SIDE].contiguous()
    got_map, got_score = predict_full_fused(crop, model, N_CLASSES)
    want_map, want_score = plain_predict(crop, model)
    agree = float((got_map == want_map).mean())
    diff = float((got_score - want_score).abs().max())
    diff_bound = 1e-3 * max(1.0, float(want_score.abs().max()))
    print(f"main path vs plain gather + stitch on a {CHECK_SIDE}^2 crop: argmax agreement "
          f"{agree} (bound >= 0.999), max |score diff| {diff} (bound <= {diff_bound})")
    if agree < 0.999 or diff > diff_bound:
        raise AssertionError("the main path disagrees with the plain composition")

    # 6. where the time goes
    print(f"profile of one {MAIN_SIDE}^2 predict: "
          + json.dumps(profile_main_path(slide, model)))
    del model

    # 7. ViT-S/8 main path: K1, the ViT with K3 in every block, K2
    from deephisto_tpu_torch.models import vit as vit_module

    vit_slide = slide[:VIT_SIDE, :VIT_SIDE].contiguous()
    vit_dense = torch.from_numpy(dense_coords(VIT_SIDE, VIT_SIDE, PS, STRIDE))
    vit = seeded_model(device, arch="vit", depth=VIT_DEPTH, stem="conv", patch=VIT_PATCH)
    n_vit = len(vit_dense)
    batches = -(-n_vit // BS)
    center_head(vit, vit.head, vit_slide, vit_dense[:: n_vit // 64][:64])
    launches, runs, warm_s, best_s, peak_gib, argmax_map = run_main_path(
        vit_slide, vit, VIT_SIDE, "ViT-S/8 path")
    for name in ("gather_normalize", "scatter_add_map", "flash_attention"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"the ViT path never launched {name}")
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
        k["launches_by_path"]["vit2p8_8192"] = launches.get(k["name"], 0) / runs
    want_k3 = VIT_DEPTH * batches * runs
    if launches.get("flash_attention") != want_k3:
        raise AssertionError(f"K3 launched {launches.get('flash_attention')} times over "
                             f"{runs} ViT predicts, not depth x batches x runs = {want_k3}")
    print(f"ViT main path: {VIT_SIDE}x{VIT_SIDE} slide, {n_vit} patches ({batches} batches), "
          f"vit2p8 (depth {VIT_DEPTH}, dim 384, 6 heads, patch {VIT_PATCH}, conv stem) bf16, "
          f"batch {BS}: warm-up {warm_s:.3f} s, best of {MAIN_TIMED_RUNS} {best_s:.4f} s = "
          f"{n_vit / best_s:.1f} patches/s; peak memory {peak_gib:.2f} GiB; launches over "
          f"{runs} runs: {launches} (K3 {launches['flash_attention'] // runs} a predict = "
          f"depth x batches); classes present "
          f"{np.bincount(argmax_map.ravel(), minlength=N_CLASSES).tolist()}")

    # 8. the ViT path vs the same model with the plain (jnp-branch) attention
    crop = slide[:VIT_CHECK_SIDE, :VIT_CHECK_SIDE].contiguous()
    got_map, got_score = predict_full_fused(crop, vit, N_CLASSES)
    flash_min = vit_module.FLASH_MIN_SEQ
    vit_module.FLASH_MIN_SEQ = 1 << 30
    try:
        want_map, want_score = predict_full_fused(crop, vit, N_CLASSES)
    finally:
        vit_module.FLASH_MIN_SEQ = flash_min
    agree = float((got_map == want_map).mean())
    scale = float(want_score.abs().max())
    diff = float((got_score - want_score).abs().max())
    print(f"ViT path vs the plain attention on a {VIT_CHECK_SIDE}^2 crop: argmax agreement "
          f"{agree} (bound >= {VIT_AGREE}), max |score diff| {diff} = {diff / scale} of the "
          f"largest |score| (bound <= {VIT_DIFF})")
    if agree < VIT_AGREE or diff > VIT_DIFF * scale:
        raise AssertionError("the ViT path disagrees with the plain attention")

    # 9. where the ViT path's time goes
    print(f"profile of one {VIT_SIDE}^2 ViT predict: "
          + json.dumps(profile_main_path(vit_slide, vit)))
    del vit, slide, vit_slide

    # 10. training main path: vit2p8 through make_fused_epoch over the sampler
    from deephisto_tpu_torch.models.patch_cls_simple import (
        get_model,
        init_model,
        make_fused_epoch,
    )
    from deephisto_tpu_torch.samplers import AnnoRegionRndSampler
    from deephisto_tpu_torch.train import create_train_state

    with tempfile.TemporaryDirectory() as root:
        pairs, data_s = train_pairs(root)
        t0 = time.perf_counter()
        sampler = AnnoRegionRndSampler(pairs, layer=TRAIN_LAYER, patch_size=PS,
                                       patches_from_one_region=4, one_image_for_batch=True,
                                       verbose=False)
        print(f"training data: {len(pairs)} synthetic {TRAIN_SIDE}^2 slides made in {data_s:.1f} s; "
              f"sampler (region table, bank {tuple(sampler.bank.images.shape)} on the card) "
              f"in {time.perf_counter() - t0:.1f} s")
    vit = init_model(get_model(N_CLASSES, arch="vit", depth=VIT_DEPTH, stem="conv",
                               patch=VIT_PATCH), seed=SEED).to(device)
    state, per_step, step_s, peak, _ = run_training(
        "vit2p8", vit, sampler, 3e-4, 0.05, TRAIN_CROP, 0.1)
    want = {"gather_multi_u8": 1, "flash_attention": VIT_DEPTH,
            "flash_attention_bwd_dkv": VIT_DEPTH, "flash_attention_bwd_dq": VIT_DEPTH}
    got = {k: per_step.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"vit2p8 training launched {got} a step, not {want}")
    for k in kernels:
        k["launches"] += int(round(per_step.get(k["name"], 0) * TRAIN_EPOCHS * TRAIN_STEPS))
        k["launches_by_path"]["vit2p8_train_step"] = per_step.get(k["name"], 0)

    # 11. the vit2p8 step vs the plain attention; the one-batch overfit
    vit_step_vs_plain(state.model, sampler, device)

    # 12. ResNet-18 training through the same epoch
    r18 = init_model(get_model(N_CLASSES, depth=18, stem="s2d"), seed=SEED).to(device)
    stats0 = r18.bn1.running_mean.clone(), r18.bn1.running_var.clone()
    _, r18_step, _, _, _ = run_training("ResNet-18 (s2d)", r18, sampler, 1e-3, 0.0, 0, 0.0)
    if torch.equal(stats0[0], r18.bn1.running_mean) or torch.equal(stats0[1], r18.bn1.running_var):
        raise AssertionError("ResNet-18 training left the BatchNorm running statistics as they were")
    for k in kernels:
        k["launches"] += int(round(r18_step.get(k["name"], 0) * TRAIN_EPOCHS * TRAIN_STEPS))
        k["launches_by_path"]["resnet18_train_step"] = r18_step.get(k["name"], 0)
    del r18

    # 13. where a vit2p8 train step's time goes
    one = make_fused_epoch(state.model, sampler, BS, 1, crop_pad=TRAIN_CROP, label_smoothing=0.1)
    gen = torch.Generator().manual_seed(SEED + 9)
    print("profile of one vit2p8 train step: "
          + json.dumps(profile_device(lambda: one(state, gen))))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
