"""Smoke test of the PyTorch + CUDA port (``deephisto_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
of JAX or of the JAX package. Phases, any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every kernel under ``deephisto_tpu_torch/csrc`` with ``nvcc``;
3. kernels vs their plain PyTorch versions on the card at the main path's
   shapes: K1 (gather + /255) bit-equal in f32 and bf16; K1's int8 mode
   (the int8 model's input quantize and stem layout fused into the gather)
   bit-equal in its three layouts at the int8 paths' shapes (s2d4: an exact
   batch; s2d8_to_s2d4: an fcn headline step; hwc: an fcn pack-4 step and a
   PackedSlide batch), timed beside its byte bound and the parent's
   composition (the uint8 gather or tile copy, the quantize and the pack as
   torch ops); K2 (stitch) bit-equal to the sequential loop and identical
   from run to run (the main path's batches, spans, the map's last rows, a
   wrapping batch, N = 1 and 2,000, a band of one tile row), timed beside its
   byte bound, the library call and an empty launch on its grid;
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
10. the card's attention threshold: a 196-token ViT-S/16 predict of the
    8192² crop with the plain attention (threshold 512) and with K3
    (threshold 196), in turns;
11. the int8 ResNet-18: a seeded s2d-stem ResNet-18 (random BN statistics)
    quantized by ``quantize_resnet`` on 32 seeded images of 224², as
    bench.py does, its head centred: K6 (the int8
    conv + epilogue, the block epilogue fused in) against its plain version
    on the inputs of every conv of one exact-path batch (256 × 224²) and of
    one fcn tile batch (16 tiles of 1152², bench.py's headline staging),
    each call in its own mode and in the f32 and int8 modes, bit-equal, two
    runs bit-identical, each timed in its own mode with its design (wgmma
    or mma.sync) beside its bound, its plain version and two yardsticks
    that are not the same function (``torch._int_mm`` on the im2col'd
    operand, cuDNN's bf16 conv);
12. the exact int8 predict on the 16384² slide (K1's int8 mode, K6, K2):
    patches/s, peak memory, launches, profile; the same predict with the
    parent's input path (K1's uint8 gather, the quantize and the s2d pack as
    torch ops): map and scores bit-equal, no round, clamp or input cast
    launched per batch in the int8 mode; the same predict with each
    block's epilogue as torch ops after K6's f32 mode (the unfused
    composition): the same map, patches/s, and launches a batch by kernel
    group, with no add, relu or cast launched per residual block in the
    fused one; and on a 2048² crop the same path with K6's plain version:
    maps equal, scores bit-equal;
13. the fcn serving mode on the 16384² slide: bench.py's headline
    (``stage_for_fcn(pack=8, pre_tile=True)``, pack_l1, tile 1024, halo 64,
    16 tiles a step), then its pack-4 int8 and bf16 rows: equivalent
    patches/s, staging seconds, peak memory, agreement with the exact int8
    map (reported, not gated), a profile of the headline, the headline with
    the parent's input path (map and scores bit-equal, no round, clamp or
    input cast per step in the int8 mode), B6 (the window pool and ensemble,
    torch ops) timed beside its byte bound, K6 a batch and the
    exact and headline predicts with every conv on the mma.sync kernel
    against K6's chosen designs, in turns, and the headline against its
    plain-K6 composition on the crop;
14. training main path: the port's synthetic dataset (3 train slides of
    3072², hard, seed 7, as benchmarks/time_to_accuracy.py), the region
    sampler (patch 224, layer 2, 4 patches a region, one image a batch), a
    seeded full-width ``vit2p8`` in bf16, AdamW (lr 3e-4, wd 0.05),
    ``crop_pad`` 16, label smoothing 0.1, batch 256, through
    ``make_fused_epoch``: one untimed epoch, then timed epochs; steps/s,
    patches/s, peak memory, finite losses, and the launches a step (K1's
    multi-slide mode 1, K3, K4 and K5 6 each);
15. one vit2p8 train step vs the same step with the plain attention (loss
    and every parameter's gradient), and 8 steps on one batch that must
    lower its loss;
16. ResNet-18 (s2d stem, Adam lr 1e-3) training through the same epoch:
    finite losses, BatchNorm running statistics moved, steps/s;
17. one vit2p8 train step with the qkv gradient as K5/K4 write it and, in
    turns, through the parent's three selects: step times and profiles by
    kernel group (launches and time).

Phase 3 also holds K3 (flash attention) against its plain version in bf16
and f32 at the ViT's shape (256, 6, 784, 64), a ragged N = 1000, N = 196
and Dh 16 and 32, times it beside its FLOP bound, its plain version and
``F.scaled_dot_product_attention`` (a yardstick only: the port never calls
it), with its design (wgmma at bf16 Dh 64), also with the lse residual on
views of one qkv projection (the train step's call), and times K3, the
plain jnp-branch attention and SDPA at 196 and 784 tokens; K5 and K4 (the
flash-attention backward; K5 first, it writes the
di that K4 reads) against their plain version at the training shape, a
ragged one, Dh 16/32/128 and f32, two runs bit-identical, timed beside their
bounds, the plain version and SDPA's backward, with their design (wgmma at
bf16 Dh 64), and timed at Dh 16, 32 and 128 too; and K1's multi-slide uint8 mode bit-equal to its plain version at
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
    """K2 against the sequential loop, bit-equal and identical from run to
    run, on a 16384² predict's (1024, 1024) map: the main path's batches,
    some off the map, spans (ps 200, d 16), the map's last rows, a batch that
    wraps (negative coords: the whole map is K2's band), N = 1 and N = 2,000,
    and a batch whose band is one tile row; timed on a main-path batch beside
    its byte bound, ``index_put_`` and an empty launch on K2's grid (its
    floor), and on the wrapping batch."""
    import ctypes

    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.ops import scatter_add_map, scatter_add_map_ref
    from deephisto_tpu_torch.ops import stitch as stitch_mod

    dh = dw = MAIN_SIDE // D
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 2)
    dense200 = torch.from_numpy(
        np.asarray([(y, x) for y in range(0, 4 * 100, 100) for x in range(0, MAIN_SIDE - 200, 100)],
                   dtype=np.int32)[:BS]
    )
    off_map = rng.integers(0, MAIN_SIDE + 2 * PS, size=(BS, 2)).astype(np.int32)
    mid = len(dense) // 7
    wraps = dense[mid:mid + BS].clone()
    wraps[::7] -= MAIN_SIDE + 6 * D  # raw coords below 0: map cells in [-dh, 0) and below
    wraps[1::9, 1] = -5 * D
    band_row = torch.from_numpy(np.stack([np.full(BS, 33 * D), np.arange(BS) * 4 * D], 1)
                                .astype(np.int32))
    cases = {  # name: (raw coords, ps) with d = 16
        "dense 224/16": (dense[:BS], 224),
        "random, some off the map, 224/16": (torch.from_numpy(off_map), 224),
        "dense 200/16 (spans)": (dense200, 200),
        "random, some off the map, 200/16 (spans)": (torch.from_numpy(off_map), 200),
        "the map's last rows, 224/16": (dense[-BS:], 224),
        "wraps (negative coords), 224/16": (wraps, 224),
        "N = 1, 224/16": (dense[mid:mid + 1], 224),
        "N = 2000, 224/16": (dense[mid:mid + 2000], 224),
        "band of one tile row, 128/16": (band_row, 128),
    }
    for name, (raw, ps) in cases.items():
        raw = raw.to(device)
        vals = torch.randn((len(raw), N_CLASSES), device=device, generator=gen)
        f = ps // D if ps % D == 0 else ps // D + 1
        spans = None if ps % D == 0 else (raw % D + ps) // D
        base = torch.randn((dh, dw, N_CLASSES), device=device, generator=gen)
        runs = [scatter_add_map(base.clone(), raw // D, vals, f, spans) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"K2 is not deterministic ({name})")
        if not torch.equal(runs[0], scatter_add_map_ref(base.clone(), raw // D, vals, f, spans)):
            raise AssertionError(f"K2 differs from its plain version ({name})")
        print(f"K2 scatter_add_map [{name}]: bit-equal to the plain loop, two runs identical")

    # timing: one main-path batch (the first 256 tiles of the dense grid)
    cds = (dense[:BS] // D).to(device)
    vals = torch.randn((BS, N_CLASSES), device=device, generator=gen)
    acc = torch.zeros((dh, dw, N_CLASSES), device=device)
    f = PS // D
    ms = cuda_ms(lambda i: scatter_add_map(acc, cds, vals, f), 50)
    plain_ms = cuda_ms(lambda i: scatter_add_map_ref(acc, cds, vals, f), 5)
    wrap_cds = (wraps // D).to(device)
    wrap_ms = cuda_ms(lambda i: scatter_add_map(acc, wrap_cds, vals, f), 50)
    lib = _build.load("stitch", stitch_mod._SIGNATURE)
    lib.dh_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dh_empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    empty_ms = cuda_ms(lambda i: _build.check(lib, lib.dh_empty_launch(device.index, dh, dw, stream),
                                              "empty launch"), 50)
    off = torch.arange(f, device=device)
    yy = (cds[:, 0, None, None] + off[None, :, None]).expand(BS, f, f).reshape(-1).long()
    xx = (cds[:, 1, None, None] + off[None, None, :]).expand(BS, f, f).reshape(-1).long()
    vv = vals[:, None, :].expand(BS, f * f, N_CLASSES).reshape(-1, N_CLASSES)
    library_ms = cuda_ms(lambda i: acc.index_put_((yy, xx), vv, accumulate=True), 50)
    c = dense[:BS].numpy() // D
    cells = {(y + a, x + b) for y, x in c for a in range(f) for b in range(f)
             if y + a < dh and x + b < dw}
    nbytes = BS * N_CLASSES * 4 + BS * 8 + 2 * len(cells) * N_CLASSES * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"K2 on a main-path batch: {ms:.4f} ms; its byte bound {bound_ms:.5f} ms, an empty "
          f"launch on its grid {empty_ms:.4f} ms (its floor); the wrapping batch (whole map) "
          f"{wrap_ms:.4f} ms; index_put_ {library_ms:.4f} ms; plain {plain_ms:.3f} ms")
    return {
        "name": "scatter_add_map", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/stitch.cu",
        "replaces": "deephisto_tpu/ops/stitch.py:107",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms, "empty_launch_ms": empty_ms, "wrapping_batch_ms": wrap_ms,
    }


def check_k3(device):
    from deephisto_tpu_torch.ops import attention as att
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
    # the train step's call: with the lse residual, on views of one
    # (B, N, 3, H, Dh) qkv projection
    lse_ms = cuda_ms(lambda i: att._forward(q, k, v, dh ** -0.5, with_lse=True), 20)
    proj = torch.randn((b, n, 3, h, dh), device=device, generator=gen).to(torch.bfloat16)
    qs, ks, vs = (proj[:, :, i].transpose(1, 2) for i in range(3))
    qkv_lse_ms = cuda_ms(lambda i: att._forward(qs, ks, vs, dh ** -0.5, with_lse=True), 20)
    del proj, qs, ks, vs
    seq = {}
    for n_tok in (196, 784):
        q2, k2, v2 = qkv(b, n_tok)
        seq[n_tok] = {
            "flash_attention_ms": cuda_ms(lambda i: flash_attention(q2, k2, v2, 0.125), 20),
            "attention_plain_ms": cuda_ms(lambda i: attention_plain(q2, k2, v2), 10),
            "sdpa_ms": cuda_ms(
                lambda i: F.scaled_dot_product_attention(q2, k2, v2, scale=0.125), 20),
        }
    bound_ms = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    design = att.attention_design(torch.bfloat16, dh)
    print(f"K3 ({design}) at ({b}, {h}, {n}, {dh}) bf16: {ms:.4f} ms = "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms; "
          f"plain {plain_ms:.3f} ms; SDPA forward {library_ms:.4f} ms; with lse {lse_ms:.4f} ms, "
          f"with lse on qkv views {qkv_lse_ms:.4f} ms")
    print(f"K3 at ({b}, {h}, N, {dh}) bf16 by tokens N (ms): " + json.dumps(seq))
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/attention.cu", "design": design,
        "replaces": "deephisto_tpu/models/vit.py:125 (jax.experimental.pallas.ops.tpu."
                    "flash_attention, flash_attention.py:131)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": library_ms, "tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
        "lse_ms": lse_ms, "qkv_views_lse_ms": qkv_lse_ms, "by_tokens": seq,
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


def quantize_ops(u8, inv0):
    """The int8 ResNet's uint8 input quantize as the parent ran it per batch,
    torch ops (``QuantizedResNet.quantize_input``)."""
    return torch.clamp(torch.round(u8.float() * (inv0 / 255.0)), -127, 127).to(torch.int8)


def check_k1_int8(slide, dense, device):
    """K1's int8 mode against its plain version in its three layouts at the
    int8 paths' shapes, bit-equal on windows with odd, clamped and negative
    starts and on a random table, two runs identical; each path's call timed
    beside its byte bound, its plain version and the parent's composition
    (K1's uint8 gather or the parent's tile copy, then the input quantize
    and the stem's pack as torch ops):

    * ``s2d4``: the exact int8 path on the raw slide (256 windows of 224²);
    * ``s2d8_to_s2d4``: the fcn headline, 16 tiles of the pack-8 pre-tiled
      staging (144² cells of 192 bytes);
    * ``hwc``: the fcn pack-4 row, 16 tiles of the pack-4 staging (288²
      cells of 48 bytes), and a ``PackedSlide`` batch (256 windows of 56²
      cells), checked only."""
    from deephisto_tpu_torch.ops import (
        gather_multi_u8,
        gather_quantize_int8,
        gather_quantize_int8_ref,
        s2d_pack4,
        unpack_s2d8,
    )
    from deephisto_tpu_torch.predict import stage_for_fcn, stage_packed_slide

    w = slide.shape[1]
    rng = np.random.default_rng(SEED + 13)
    inv0 = torch.tensor(127.0 / 0.9993, dtype=torch.float32, device=device)  # a calibrated scale
    lut = quantize_ops(torch.arange(256, dtype=torch.uint8, device=device), inv0)
    rand_lut = torch.from_numpy(rng.integers(-128, 128, 256).astype(np.int8)).to(device)
    tiles8 = stage_for_fcn(slide, tile=FCN_TILE, halo=FCN_HALO, pack=8, pre_tile=True,
                           device=device).tiles
    packed4 = stage_for_fcn(slide, tile=FCN_TILE, halo=FCN_HALO, pack=4, device=device).packed
    ps8, ps4 = (FCN_TILE + 2 * FCN_HALO) // 8, (FCN_TILE + 2 * FCN_HALO) // 4
    tx = -(-w // FCN_TILE)
    # timed batches, in turn, so a call does not find its input in L2
    n_exact, n_fcn = min(16, len(dense) // BS), min(8, tiles8.shape[0] // FCN_TB)

    def tile_batch(step):
        t = np.arange(step * FCN_TB, (step + 1) * FCN_TB)
        return t.astype(np.int32), (np.stack([t // tx, t % tx], 1) * (FCN_TILE // 4)).astype(np.int32)

    zeros = np.zeros((FCN_TB, 2), np.int32)
    one = np.zeros(BS, np.int32)
    cases = {  # name: (bank, slide idx, coords of the timed batches, ps, layout, parent)
        "exact_s2d4": (slide[None], [one] * n_exact,
                       [dense[i * BS:(i + 1) * BS].numpy() for i in range(n_exact)], PS, "s2d4",
                       lambda b, s, c: s2d_pack4(quantize_ops(gather_multi_u8(b, s, c, PS), inv0))
                       .contiguous()),
        "fcn_headline_s2d8_to_s2d4": (
            tiles8, [tile_batch(i)[0] for i in range(n_fcn)], [zeros] * n_fcn, ps8, "s2d8_to_s2d4",
            lambda b, s, c: unpack_s2d8(quantize_ops(b[torch.from_numpy(s).to(device).long()], inv0))
            .contiguous()),
        "fcn_pack4_hwc": (
            packed4[None], [np.zeros(FCN_TB, np.int32)] * n_fcn,
            [tile_batch(i)[1] for i in range(n_fcn)], ps4, "hwc",
            lambda b, s, c: quantize_ops(torch.stack([b[0, y:y + ps4, x:x + ps4] for y, x in c.tolist()]),
                                         inv0)),
    }
    packed_slide = stage_packed_slide(slide, keep_raw=False, device=device).packed
    checks = [(b, s[0], c[0], ps, lay) for b, s, c, ps, lay, _ in cases.values()]
    checks.append((packed_slide[None], one, dense[:BS].numpy() // 4, PS // 4, "hwc"))
    out = {}
    for bank, sidx, coords, ps, layout in checks:
        # odd, clamped and negative starts on the first windows
        coords = coords.copy()
        n, (sh, sw) = len(coords), bank.shape[1:3]
        edge = [(sh - ps, sw - ps), (1, 3), (5, sw - 1), (-1, -2), (sh, -sw - 7), (2, 1)]
        k = min(n, len(edge))
        coords[:k] = edge[:k]
        sidx = sidx.copy()
        sidx[:2] = [-1, bank.shape[0]]
        for table in (lut, rand_lut):
            got = gather_quantize_int8(bank, sidx, coords, ps, table, layout)
            again = gather_quantize_int8(bank, sidx, coords, ps, table, layout)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K1's int8 mode is not deterministic ({layout}, ps {ps})")
            if not torch.equal(got, gather_quantize_int8_ref(bank, sidx, coords, ps, table, layout)):
                raise AssertionError(f"K1's int8 mode differs from its plain version ({layout}, "
                                     f"bank {tuple(bank.shape)}, ps {ps})")
        print(f"K1 gather_quantize_int8 [{layout}]: bit-equal to the plain version at N={n}, "
              f"window {ps}, bank {tuple(bank.shape)} (odd, clamped and negative starts; the "
              "model's table and a random one), two runs identical")
    for name, (bank, sidxs, coordss, ps, layout, parent) in cases.items():
        m = len(coordss)
        batches = [(torch.from_numpy(s).to(device), torch.from_numpy(c).to(device))
                   for s, c in zip(sidxs, coordss)]
        if not torch.equal(gather_quantize_int8(bank, *batches[0], ps, lut, layout),
                           parent(bank, sidxs[0], coordss[0])):
            raise AssertionError(f"K1's int8 mode differs from the parent's composition ({name})")
        ms = cuda_ms(lambda i: gather_quantize_int8(bank, *batches[i % m], ps, lut, layout), 4 * m)
        plain_ms = cuda_ms(
            lambda i: gather_quantize_int8_ref(bank, *batches[i % m], ps, lut, layout), m)
        parent_ms = cuda_ms(lambda i: parent(bank, sidxs[i % m], coordss[i % m]), 2 * m)
        c = bank.shape[3]
        if layout == "s2d8_to_s2d4":  # whole tiles, no overlap
            read = [FCN_TB * ps * ps * c] * m
        else:  # the bytes under the union of the batch's windows
            read = [covered_pixels(cc, ps) * c for cc in coordss]
        nbytes = np.mean(read) + len(coordss[0]) * (ps * ps * c + 12) + 256
        out[name] = {"layout": layout, "ms": ms, "plain_ms": plain_ms, "parent_ms": parent_ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "windows": len(coordss[0]),
                     "window": ps, "bank": list(bank.shape)}
        print(f"K1 gather_quantize_int8 [{name}]: {ms:.4f} ms against its byte bound "
              f"{out[name]['bound_ms']:.4f} ms; the parent's composition {parent_ms:.4f} ms; "
              f"plain {plain_ms:.4f} ms")
    del tiles8, packed4, packed_slide
    main = out["exact_s2d4"]
    return {
        "name": "gather_quantize_int8", "route": "cuda",
        "source": "deephisto_tpu_torch/csrc/gather.cu",
        "replaces": "deephisto_tpu/experimental/pallas_gather.py:152 (the gather, as "
                    "gather_patches_multi_xla, deephisto_tpu/ops/gather.py:59) with the input "
                    "quantize of deephisto_tpu/models/quantize.py:493-496 and the s2d stem's pack "
                    "fused in",
        "max_abs_err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "parent_composition_ms": main["parent_ms"],
        "note": "ms, plain_ms and bound_ms: one exact int8 batch (s2d4); by_layout has the fcn "
                "steps", "by_layout": out,
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

    def times(shape, plain):
        """K5, K4 (K5 first: it writes the di that K4 reads), the backward,
        SDPA's backward and, if ``plain``, the plain version, in ms, at
        ``shape`` in bf16."""
        b, h, n, dh = shape
        scale = dh ** -0.5
        q, k, v, do = (torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = att._forward(q, k, v, scale, with_lse=True)
        do_, o_, lse_, di = att._bwd_operands(q, k, v, out, lse, do)
        grads = torch.empty((b, n, 3, h, dh), dtype=q.dtype, device=device)
        dq, dk, dv = (grads[:, :, i].transpose(1, 2) for i in range(3))
        t = {"k5_ms": cuda_ms(lambda i: att._bwd_launch(att.KERNEL_DQ, q, k, v, do_, o_, lse_,
                                                        di, (dq,), scale), 20),
             "k4_ms": cuda_ms(lambda i: att._bwd_launch(att.KERNEL_DKV, q, k, v, do_, o_, lse_,
                                                        di, (dk, dv), scale), 20),
             "backward_ms": cuda_ms(lambda i: flash_attention_bwd(q, k, v, out, lse, do, scale),
                                    20)}
        if plain:
            t["plain_ms"] = cuda_ms(
                lambda i: flash_attention_bwd_ref(q, k, v, out, lse, do, scale), 3)
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, scale=scale)
        t["sdpa_backward_ms"] = cuda_ms(lambda i: torch.autograd.grad(
            o_sdpa, (qs, ks, vs), do, retain_graph=True), 20)
        return t

    b, h, n, dh = K45_SHAPES[0]
    t = times(K45_SHAPES[0], plain=True)
    dq_ms, dkv_ms, bwd_ms = t["k5_ms"], t["k4_ms"], t["backward_ms"]
    plain_ms, sdpa_bwd_ms = t["plain_ms"], t["sdpa_backward_ms"]
    prod = 2 * b * h * n * n * dh  # one N×N×Dh product
    whole_bound = 5 * prod / BF16_FLOP_PER_S * 1e3
    # each kernel's bound: the products its function needs from its inputs
    # (K5: S, dP, dQ; K4: S, dP, dV, dK)
    dq_bound, dkv_bound = 3 * prod / BF16_FLOP_PER_S * 1e3, 4 * prod / BF16_FLOP_PER_S * 1e3
    design = att.attention_design(torch.bfloat16, dh)
    print(f"K4+K5 ({design}) at ({b}, {h}, {n}, {dh}) bf16: K5 (dQ, di) {dq_ms:.4f} ms = "
          f"{3 * prod / dq_ms / 1e9:.1f} TFLOP/s, {dq_bound / dq_ms:.1%} of its bound "
          f"{dq_bound:.4f} ms; K4 (dK, dV) {dkv_ms:.4f} ms = {4 * prod / dkv_ms / 1e9:.1f} "
          f"TFLOP/s, {dkv_bound / dkv_ms:.1%} of its bound {dkv_bound:.4f} ms; the backward "
          f"(K5, K4) {bwd_ms:.4f} ms = {5 * prod / bwd_ms / 1e9:.1f} TFLOP/s, "
          f"{whole_bound / bwd_ms:.1%} of the 5-product bound {whole_bound:.4f} ms; plain "
          f"{plain_ms:.3f} ms; SDPA backward {sdpa_bwd_ms:.4f} ms")
    # the other bf16 head widths at the same B, H, N (the mma.sync design)
    by_width = {}
    for w in (16, 32, 128):
        by_width[w] = dict(times((b, h, n, w), plain=False), design=att.attention_design(
            torch.bfloat16, w))
        print(f"K4+K5 ({by_width[w]['design']}) at ({b}, {h}, {n}, {w}) bf16: "
              + ", ".join(f"{key} {val:.4f}" for key, val in by_width[w].items()
                          if key != "design"))
    common = {"route": "cuda", "source": "deephisto_tpu_torch/csrc/attention_bwd.cu",
              "design": design, "plain_ms": plain_ms, "library_ms": sdpa_bwd_ms,
              "bound_by": "operations", "backward_ms": bwd_ms, "backward_bound_ms": whole_bound,
              "other_head_widths": by_width}
    return [
        dict(common, name=att.KERNEL_DKV, max_abs_err=err[att.KERNEL_DKV], ms=dkv_ms,
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                      "(_flash_attention_bwd_dkv), from deephisto_tpu/models/vit.py:125,130",
             bound_ms=dkv_bound, tflops=4 * prod / dkv_ms / 1e9),
        dict(common, name=att.KERNEL_DQ, max_abs_err=err[att.KERNEL_DQ], ms=dq_ms,
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                      "(_flash_attention_bwd_dq), from deephisto_tpu/models/vit.py:125,130",
             bound_ms=dq_bound, tflops=3 * prod / dq_ms / 1e9),
    ]


def run_timed(fn, label, side, runs=MAIN_TIMED_RUNS):
    """One warm-up call of ``fn`` (a predict of a ``side``² slide), then the
    best of ``runs``, with every launch count set to 0 just before and read
    just after. Checks the maps and returns (launches, calls, warm s, best
    s, peak GiB, (argmax map, score map))."""
    from deephisto_tpu_torch import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    best_s = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best_s = min(best_s, time.perf_counter() - t0)
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    argmax_map, score_map = out
    if argmax_map.shape != (side // D,) * 2 or argmax_map.dtype != np.uint8:
        raise AssertionError(f"{label}: argmax map {argmax_map.shape} {argmax_map.dtype}")
    if int(argmax_map.max()) >= N_CLASSES:
        raise AssertionError(f"{label}: argmax map holds a class id >= n_classes")
    if tuple(score_map.shape) != argmax_map.shape + (N_CLASSES,):
        raise AssertionError(f"{label}: score map {tuple(score_map.shape)}")
    if not bool(torch.isfinite(score_map).all()):
        raise AssertionError(f"{label}: score map is not finite")
    print(f"{label}: warm-up {warm_s:.3f} s, best of {runs} {best_s:.4f} s; peak memory "
          f"{peak:.2f} GiB; launches over {1 + runs} runs: {launches}")
    return launches, 1 + runs, warm_s, best_s, peak, out


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
    ("gather_quantize_int8", "K1 gather_quantize_int8"),
    ("gather_normalize", "K1 gather_normalize"), ("scatter_add_map", "K2 scatter_add_map"),
    ("gather_multi_u8", "K1 gather_multi_u8"), ("conv_int8", "K6 conv_int8"),
    ("flash_fwd", "K3 flash_attention"),
    ("flash_bwd_dkv", "K4 flash_attention_bwd_dkv"), ("flash_bwd_dq", "K5 flash_attention_bwd_dq"),
    ("adam", "optimizer"), ("layer_norm", "LayerNorm"), ("gelu", "GELU"),
    ("batch_norm", "batch norm"), ("addpadding", "cuDNN input padding"),
    ("fprop", "convolution"), ("conv", "convolution"), ("max_pool", "max pool"),
    ("gemm", "GEMM (Dense)"), ("nvjet", "GEMM (Dense)"), ("cutlass", "GEMM (Dense)"),
    ("dgrad", "convolution backward"), ("wgrad", "convolution backward"),
    ("xmma", "GEMM (Dense)"), ("clamp", "relu / clamp"), ("round_kernel", "round"),
    ("copy", "dtype casts / copies"),
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
    spans, groups, names, counts = [], {}, {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        spans.append((start, start + dur))
        group = next((g for k, g in KERNEL_GROUPS if k in e.name.lower()), "other")
        groups[group] = groups.get(group, 0.0) + dur
        counts[group] = counts.get(group, 0) + 1
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
        "group_launches": counts,
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


# ---- int8: K6, the exact int8 predict and the fcn serving mode ------------

INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
CALIB_N = 32  # calibration images, as bench.py (rng.random((32, 224, 224, 3)))
FCN_TILE, FCN_HALO, FCN_TB = 1024, 64, 16  # bench.py's headline fcn configuration
INT8_CHECK_SIDE = 2048  # crop of the int8 paths vs their plain-K6 composition


class RecordConvs:
    """Within ``with``: every K6 call of the int8 ResNet (its f32, int8 and
    block modes) is recorded as (mode, its inputs on the card) and, with
    ``plain=True``, served by K6's plain version (the plain-K6
    composition); with ``unfused=True`` each block-mode call runs as K6's
    f32 mode followed by the block epilogue as torch ops (the unfused
    composition)."""

    def __init__(self, record=True, plain=False, unfused=False):
        self.record, self.plain, self.unfused, self.calls = record, plain, unfused, []

    def __enter__(self):
        from deephisto_tpu_torch.models import quantize as qmod
        from deephisto_tpu_torch.ops import conv_int8 as k6

        self._saved = qmod.conv_f32, qmod.conv_to_int8, qmod.conv_int8_block

        def wrap(fn, mode):
            def conv(x, w, stride, pads, a, b, *epi):
                args = (x, w, stride, pads, a, b, *epi)
                if self.record:
                    self.calls.append((mode, args))
                if self.plain:
                    return _plain_k6(mode, args)
                if self.unfused and mode == "block":
                    return k6.block_epilogue_ref(k6.conv_f32(*args[:6]), *epi)
                return fn(*args)
            return conv

        qmod.conv_f32 = wrap(self._saved[0], "f32")
        qmod.conv_to_int8 = wrap(self._saved[1], "int8")
        qmod.conv_int8_block = wrap(self._saved[2], "block")
        return self

    def __exit__(self, *exc):
        from deephisto_tpu_torch.models import quantize as qmod

        qmod.conv_f32, qmod.conv_to_int8, qmod.conv_int8_block = self._saved


def im2col(x, k: int, stride: int, pads) -> torch.Tensor:
    """(M, K) int8 GEMM operand of an NHWC conv, K ordered (kh, kw, ci) as
    the (Cout, KH, KW, Cin) kernel's rows."""
    (pt, pb), (pl, pr) = pads
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    n, hp, wp, c = xp.shape
    oh, ow = (hp - k) // stride + 1, (wp - k) // stride + 1
    cols = [xp[:, r:r + stride * (oh - 1) + 1:stride, s:s + stride * (ow - 1) + 1:stride]
            for r in range(k) for s in range(k)]
    return torch.cat(cols, dim=-1).reshape(n * oh * ow, k * k * c)


def yardsticks(x, w, stride: int, pads) -> tuple:
    """ms of ``torch._int_mm`` on the im2col'd operand of the same GEMM (the
    im2col not timed) and of cuDNN's bf16 conv of the same shape: yardsticks,
    not the same function (no epilogue, no int8 conv). A shape that a
    library call refuses gets None and the reason is printed; the port
    never calls either."""
    F = torch.nn.functional
    cout, k = w.shape[0], w.shape[1]
    out = []
    try:
        cols = im2col(x, k, stride, pads)
        wt = w.reshape(cout, -1).t()
        out.append(cuda_ms(lambda i: torch._int_mm(cols, wt), 10))
        del cols
    except RuntimeError as e:
        print(f"_int_mm yardstick at {tuple(x.shape)} x {tuple(w.shape)}: {str(e)[:200]}")
        out.append(None)
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        out.append(cuda_ms(lambda i: F.conv2d(xb, wb, stride=stride, padding=(pt, pl)), 10))
    else:
        out.append(cuda_ms(lambda i: F.conv2d(F.pad(xb, (pl, pr, pt, pb)), wb, stride=stride), 10))
    return tuple(out)


OUT_BYTES = {"f32": 4, "int8": 1, "carry": 3}  # bytes an output element
RES_BYTES = {"none": 0, "bf16": 2, "f32": 4, "int8": 1}


def conv_bytes_ops(x, w, mode: str, epi, oh: int, ow: int) -> tuple[float, float]:
    """Bytes a K6 call must move (input, kernel, constants read once; a block
    call's residual read once and its outputs, the carry's bf16 and int8,
    written once) and its operations (2 a multiply-add)."""
    n = x.shape[0]
    cout, kh, kw, cin = w.shape
    m = n * oh * ow
    res_kind, out = (epi[1], epi[4]) if mode == "block" else ("none", mode)
    nbytes = (x.numel() + w.numel() + 8 * cout + 8
              + m * cout * (OUT_BYTES[out] + RES_BYTES[res_kind]))
    return nbytes, 2.0 * m * cout * kh * kw * cin


def _run_k6(mode, args):
    from deephisto_tpu_torch.ops import conv_int8 as k6

    if mode == "block":
        return k6.conv_int8_block(*args)
    return k6.conv_int8(*args[:6], to_int8=mode == "int8")


def _plain_k6(mode, args):
    from deephisto_tpu_torch.ops import conv_int8 as k6

    if mode == "block":
        return k6.conv_int8_block_ref(*args)
    return k6.conv_int8_ref(*args[:6], to_int8=mode == "int8")


def _equal(got, want) -> bool:
    """Tensors or tuples equal by value (a bf16 carry's -0 equals +0)."""
    got, want = ((t if isinstance(t, tuple) else (t,)) for t in (got, want))
    return all(g.dtype == v.dtype and torch.equal(g, v) for g, v in zip(got, want))


def check_k6(calls_by_path: dict) -> tuple[dict, dict]:
    """K6 against its plain version on the recorded calls of each path (the
    convs of one batch of the exact path and of one tile batch of the fcn
    path): each call in its own mode (a block call in its residual kind and
    output) and in both f32 and int8 modes, bit-equal (by value), two runs
    identical; each distinct call timed in its own mode beside its bound,
    its plain version and two yardsticks that are not the same function
    (``torch._int_mm`` on the im2col'd operand, and cuDNN's bf16 conv of the
    same shape), with its design. Returns (the kernels-line entry, per-path
    sums)."""
    from deephisto_tpu_torch.ops import conv_int8 as k6

    sums, rows, seen = {}, [], {}
    for path, calls in calls_by_path.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, int_mm_ms=0.0,
                   cudnn_bf16_ms=0.0, calls=len(calls), designs={})
        for mode, args in calls:
            x, w, stride, pads, a, b = args[:6]
            modes = [("f32", args[:6]), ("int8", args[:6])]
            if mode == "block":
                modes.append(("block", args))
            outs = {}
            for m, margs in modes:
                got = _run_k6(m, margs)
                again = _run_k6(m, margs)
                torch.cuda.synchronize()
                if not _equal(got, again):
                    raise AssertionError(f"K6 is not deterministic at {tuple(x.shape)} ({m})")
                if not _equal(got, _plain_k6(m, margs)):
                    raise AssertionError(f"K6 differs from its plain version at {tuple(x.shape)} "
                                         f"x {tuple(w.shape)} stride {stride} mode {m} "
                                         f"{args[7] if m == 'block' else ''} "
                                         f"{args[10] if m == 'block' else ''}")
                outs[m] = got
            epi = args[6:]
            label = mode if mode != "block" else f"block {epi[1]} -> {epi[4]}"
            design = k6.conv_design(x.shape[3])
            key = (tuple(x.shape), tuple(w.shape), stride, pads, label)
            if key not in seen:
                oh, ow = outs["f32"].shape[1:3]
                nbytes, ops = conv_bytes_ops(x, w, mode, epi, oh, ow)
                ms = cuda_ms(lambda i: _run_k6(mode, args), 10)
                plain_ms = cuda_ms(lambda i: _plain_k6(mode, args), 2, warmup=1)
                int_mm_ms, cudnn_ms = yardsticks(x, w, stride, pads)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / INT8_OP_PER_S * 1e3
                seen[key] = dict(path=path, x=list(x.shape), w=list(w.shape), stride=stride,
                                 pads=[list(p) for p in pads], mode=label, design=design, ms=ms,
                                 plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                                 bound_ms=max(bytes_ms, ops_ms), tops=ops / ms / 1e9,
                                 int_mm_ms=int_mm_ms, cudnn_bf16_ms=cudnn_ms)
                rows.append(seen[key])
                print(f"K6 conv_int8 [{path}] {design} x {tuple(x.shape)} w {tuple(w.shape)} "
                      f"stride {stride} pads {pads} {label}: bit-equal to the plain version in "
                      f"{', '.join(outs)}; {ms:.4f} ms = {ops / ms / 1e9:.1f} TOP/s, bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms ({'bytes' if bytes_ms > ops_ms else 'ops'}); "
                      f"plain {plain_ms:.3f} ms; yardsticks (not the same function): _int_mm "
                      f"{int_mm_ms} ms, cuDNN bf16 conv {cudnn_ms} ms")
            r = seen[key]
            for f in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                tot[f] += r[f]
            for f in ("int_mm_ms", "cudnn_bf16_ms"):
                tot[f] = None if tot[f] is None or r[f] is None else tot[f] + r[f]
            tot["designs"][design] = tot["designs"].get(design, 0) + 1
            del outs
        sums[path] = tot
        print(f"K6 over the {len(calls)} convs of one {path} batch: " + json.dumps(tot))
    main = sums["exact_int8_batch"]
    entry = {
        "name": "conv_int8", "route": "cuda", "source": "deephisto_tpu_torch/csrc/conv_int8.cu",
        "replaces": "deephisto_tpu/models/quantize.py:460 (conv_s32 / conv_f32 / conv_to_int8, "
                    "XLA-lowered on the TPU, and the block epilogue of :669-684)",
        "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes" if main["bytes_ms"] > main["ops_ms"] else "operations",
        "library_ms": None,
        "design": {p: s["designs"] for p, s in sums.items()},
        "note": "ms, plain_ms and bound_ms sum the 20 convs of one exact-path batch of 256, "
                "each in its own mode (block convs with their fused epilogue)",
        "yardsticks_not_the_same_function": {
            p: {"int_mm_ms": s["int_mm_ms"], "cudnn_bf16_conv_ms": s["cudnn_bf16_ms"]}
            for p, s in sums.items()},
        "by_path": sums, "by_call": rows,
    }
    return entry, sums


class ForceDesign:
    """Within ``with``: every K6 launch takes ``design`` (None: the
    chooser's); the mma.sync kernel runs any conv."""

    def __init__(self, design):
        self.design = design

    def __enter__(self):
        from deephisto_tpu_torch.ops import conv_int8 as k6

        self._saved = k6.conv_design
        if self.design is not None:
            k6.conv_design = lambda cin: self.design
        return self

    def __exit__(self, *exc):
        from deephisto_tpu_torch.ops import conv_int8 as k6

        k6.conv_design = self._saved


def design_ab(calls_by_path: dict, predicts: dict) -> dict:
    """K6 a batch (the recorded calls, each in its own mode) and each predict
    of ``predicts`` ({label: (fn, patches)}) with every conv on the mma.sync
    kernel (K6's first design, the block epilogue fused) and with
    ``conv_design``'s choice, in turns (mma.sync, chooser, chooser,
    mma.sync); predicts best of 2 after a warm-up."""
    out = {}
    for design in ("mma.sync", None, None, "mma.sync"):
        r = out.setdefault(design or "conv_design", {"k6_batch_ms": {}, "patches_per_s": {}})
        with ForceDesign(design):
            for path, calls in calls_by_path.items():
                ms = sum(cuda_ms(lambda i: _run_k6(m, a), 10) for m, a in calls)
                r["k6_batch_ms"].setdefault(path, []).append(ms)
            for label, (fn, n) in predicts.items():
                _, _, _, best, _, _ = run_timed(fn, f"{label}, K6 {design or 'conv_design'}",
                                                MAIN_SIDE, runs=2)
                r["patches_per_s"].setdefault(label, []).append(n / best)
    return out


def seeded_int8(device, model, slide, dense):
    """``quantize_resnet`` of ``model`` on CALIB_N seeded [0, 1) images of
    224² (as bench.py calibrates), its head centred over patches spread
    across the slide. Returns (exact model, pack_l1 model sharing its
    buffers, seconds)."""
    import copy

    from deephisto_tpu_torch.models import quantize_resnet
    from deephisto_tpu_torch.ops import gather_multi_u8

    rng = np.random.default_rng(SEED + 11)
    calib = [rng.random((CALIB_N, PS, PS, 3)).astype(np.float32)]
    t0 = time.perf_counter()
    qmodel = quantize_resnet(model, calib)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    coords = dense[:: max(1, len(dense) // 64)][:64]
    x = gather_multi_u8(slide[None], torch.zeros(len(coords), dtype=torch.int32), coords, PS)
    with torch.inference_mode():
        feats = qmodel(x, features=True).float().mean(dim=(1, 2))
    qmodel.fc_bias -= feats.mean(0) @ qmodel.fc_kernel
    qpack = copy.copy(qmodel)  # the same buffers; pack_l1 is math in the port
    qpack.pack_l1 = True
    return qmodel, qpack, secs


def int8_vs_plain(fn, label):
    """``fn()`` (a predict) with K6, then with K6's plain version on the
    card: maps equal and scores bit-equal (the rest of the path is the
    same kernels)."""
    got_map, got_score = fn()
    with RecordConvs(record=False, plain=True):
        want_map, want_score = fn()
    torch.cuda.synchronize()
    same = bool(torch.equal(got_score, want_score))
    agree = float((got_map == want_map).mean())
    print(f"{label} with K6 vs with K6's plain version: argmax agreement {agree}, scores "
          f"bit-equal {same}")
    if agree != 1.0 or not same:
        raise AssertionError(f"{label} disagrees with its plain-K6 composition")


class ParentInput:
    """Within ``with``: both int8 predicts take their input as the parent
    did: K1's uint8 gather, then ``model.quantize_input`` and the stem's
    pack as torch ops, in place of K1's int8 mode (the pre-tiled fcn
    staging's tile copy is the same gather of whole tiles)."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        from deephisto_tpu_torch.ops import gather_multi_u8, s2d_pack4, unpack_s2d8
        from deephisto_tpu_torch.predict import fcn, pipeline

        def parent(images, slide_idx, coords, ps, lut, layout):
            x8 = self.model.quantize_input(gather_multi_u8(images, slide_idx, coords, ps))
            if layout == "s2d4":
                x8 = s2d_pack4(x8)
            elif layout == "s2d8_to_s2d4":
                x8 = unpack_s2d8(x8)
            return x8.contiguous()

        self._saved = pipeline.gather_quantize_int8, fcn.gather_quantize_int8
        pipeline.gather_quantize_int8 = fcn.gather_quantize_int8 = parent
        return self

    def __exit__(self, *exc):
        from deephisto_tpu_torch.predict import fcn, pipeline

        pipeline.gather_quantize_int8, fcn.gather_quantize_int8 = self._saved


def parent_input_ab(fn, model, out, prof, n_units, label, n_equiv) -> dict:
    """``fn()`` (an int8 predict whose output was ``out`` and profile
    ``prof``) with the parent's input path (:class:`ParentInput`): the same
    map and the same scores bit for bit; and, per batch or tile step
    (``n_units`` a predict), no round and no clamp launched in ``prof`` and
    at least two casts / copies fewer than the parent's path launches."""
    with ParentInput(model):
        _, _, _, best_s, _, (pmap, pscore) = run_timed(
            fn, f"{label}, the parent's input path", MAIN_SIDE, runs=2)
        pprof = profile_device(fn)
    if not (np.array_equal(pmap, out[0]) and torch.equal(pscore, out[1])):
        raise AssertionError(f"the {label} differs from the parent's input path")
    groups = ("round", "relu / clamp", "dtype casts / copies")
    per_unit = {g: {"int8_mode": prof["group_launches"].get(g, 0) / n_units,
                    "parent_input": pprof["group_launches"].get(g, 0) / n_units} for g in groups}
    print(f"{label} vs the parent's input path: map and scores bit-equal; launches per batch or "
          f"step {json.dumps(per_unit)}; patches/s (best of 2) {n_equiv / best_s:.1f} with the "
          "parent's input path")
    if (per_unit["round"]["int8_mode"] > 0 or per_unit["relu / clamp"]["int8_mode"] >= 1
            or per_unit["dtype casts / copies"]["int8_mode"]
            > per_unit["dtype casts / copies"]["parent_input"] - 2):
        raise AssertionError(f"the {label} still casts, rounds or clamps its input per batch: "
                             f"{per_unit}")
    return {"patches_per_s": n_equiv / best_s, "best_s": best_s, "launches_per_unit": per_unit,
            "profile": pprof}


def time_b6(device) -> dict:
    """B6, left to torch ops: the 7×7 window pool (``_avg_pool_f32``) and
    the window ensemble (``_window_ensemble``) of one fcn predict at the
    16384² slide's shapes (a (512, 512, 5) f32 logit map, (506, 506, 5)
    window logits, a (1024, 1024) map), each timed beside its byte bound
    (inputs read once, outputs written once), with its kernel launches."""
    from deephisto_tpu_torch.predict import fcn

    ft, t = FCN_TILE // 32, -(-MAIN_SIDE // FCN_TILE)
    wf, up, k, m = PS // 32, 32 // D, (MAIN_SIDE - PS) // 32 + 1, MAIN_SIDE // D
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    logit_map = torch.randn((t * ft, t * ft, N_CLASSES), device=device, generator=gen)
    wlog = fcn._avg_pool_f32(logit_map, wf)[:k, :k].contiguous()
    calls = {"avg_pool_f32": (lambda i: fcn._avg_pool_f32(logit_map, wf),
                              logit_map.numel() * 4 + k * k * N_CLASSES * 4),
             "window_ensemble": (lambda i: fcn._window_ensemble(wlog, wf, up, k, k, m, m),
                                 wlog.numel() * 4 + m * m * (N_CLASSES * 4 + 1))}
    out = {}
    for name, (fn, nbytes) in calls.items():
        prof = profile_device(lambda: fn(0))
        out[name] = {"ms": cuda_ms(fn, 20), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "launches": sum(prof["group_launches"].values())}
    print(f"B6 (torch ops) of one {MAIN_SIDE}^2 fcn predict: {json.dumps(out)}")
    return out


def qkv_split_ab(one, state, gen) -> dict:
    """One vit2p8 train step (``one``, an epoch of one step) profiled and
    timed with the qkv gradient taken from K5/K4's buffer as it is
    (``flash_attention_qkv``, the port's path) and with the three
    ``qkv[:, :, i]`` selects of the parent's ``MHA.forward``, whose backward
    runs a zeros, a copy and an add into the whole qkv gradient per select;
    in turns (selects, buffer, buffer, selects), best step time of 3 each."""
    from deephisto_tpu_torch.models import vit as vit_module
    from deephisto_tpu_torch.ops import attention_plain, flash_attention

    def selects(qkv, use_flash):
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if use_flash:
            return flash_attention(q, k, v, q.shape[-1] ** -0.5)
        return attention_plain(q, k, v)

    buffer = vit_module._attention
    out = {"selects": {"step_ms": []}, "buffer": {"step_ms": []}}
    try:
        for variant in ("selects", "buffer", "buffer", "selects"):
            vit_module._attention = selects if variant == "selects" else buffer
            one(state, gen)  # warm
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one(state, gen)
                torch.cuda.synchronize()
                out[variant]["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if "profile" not in out[variant]:
                out[variant]["profile"] = profile_device(lambda: one(state, gen))
    finally:
        vit_module._attention = buffer
    for v in out.values():
        v["best_step_ms"] = min(v["step_ms"])
    return out


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
    for name, log in _build.build_logs.items():  # ptxas -v: registers and spills a kernel
        usage, kernel = [], "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][-60:]
            elif "Used" in line or "spill" in line:
                usage.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        print(f"ptxas {name}.cu: " + " | ".join(usage))

    # 3. kernels vs plain at the main path's shapes
    slide = seeded_slide(device)
    dense = torch.from_numpy(dense_coords(MAIN_SIDE, MAIN_SIDE, PS, STRIDE))
    kernels = [check_k1(slide, dense), check_k1_multi(device), check_k1_int8(slide, dense, device),
               check_k2(dense, device), check_k3(device), *check_k45(device)]
    for k in kernels:
        k["launches"] = 0
        k["launches_by_path"] = {}

    # 4. main path
    model = seeded_model(device, depth=18)
    n_patches = len(dense)
    center_head(model, model.fc, slide, dense[:: n_patches // 64][:64])
    launches, runs, warm_s, best_s, peak_gib, (argmax_map, _) = run_timed(
        lambda: predict_full_fused(slide, model, N_CLASSES), "ResNet-18 path", MAIN_SIDE)
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
    launches, runs, warm_s, best_s, peak_gib, (argmax_map, _) = run_timed(
        lambda: predict_full_fused(vit_slide, vit, N_CLASSES), "ViT-S/8 path", VIT_SIDE)
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
    del vit

    # 10. the card's attention threshold: a 196-token ViT-S/16 predict with
    # the plain attention (threshold 512, the TPU's) and with K3 (threshold
    # 196), in turns
    vit16 = seeded_model(device, arch="vit", depth=VIT_DEPTH)
    center_head(vit16, vit16.head, vit_slide, vit_dense[:: n_vit // 64][:64])
    flash_min = vit_module.FLASH_MIN_SEQ
    by_threshold = {512: [], 196: []}
    try:
        for threshold in (512, 196, 196, 512):
            vit_module.FLASH_MIN_SEQ = threshold
            _build.reset_launches()
            _, _, _, best_s, _, _ = run_timed(
                lambda: predict_full_fused(vit_slide, vit16, N_CLASSES),
                f"ViT-S/16 (196 tokens) predict, FLASH_MIN_SEQ {threshold}", VIT_SIDE, runs=2)
            by_threshold[threshold].append(n_vit / best_s)
    finally:
        vit_module.FLASH_MIN_SEQ = flash_min
    print(f"ViT-S/16 {VIT_SIDE}^2 predict patches/s by attention threshold (plain at 512, K3 at "
          f"196; in turns 512, 196, 196, 512): {json.dumps(by_threshold)}; the port's card "
          f"threshold FLASH_MIN_SEQ = {flash_min}")
    del vit16, vit_slide

    # 11. the int8 ResNet-18 (s2d stem): quantize, stage the fcn headline,
    # record one batch's convs on each path and hold K6 against its plain
    # version on them
    from deephisto_tpu_torch.ops import gather_quantize_int8
    from deephisto_tpu_torch.predict import (
        fcn_equivalent_patches,
        predict_full_fcn,
        stage_for_fcn,
        tile_logits,
    )

    r18 = seeded_model(device, depth=18, stem="s2d")
    qexact, qpack, quant_s = seeded_int8(device, r18, slide, dense)
    center_head(r18, r18.fc, slide, dense[:: n_patches // 64][:64])
    print(f"int8 ResNet-18 (s2d): quantize_resnet on {CALIB_N} images of {PS}^2 in {quant_s:.2f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = stage_for_fcn(slide, tile=FCN_TILE, halo=FCN_HALO, pack=8, pre_tile=True)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    slide0 = torch.zeros((BS,), dtype=torch.int32)

    def record_k6_calls() -> dict:
        """The K6 calls of one exact batch and of one fcn tile batch, by path."""
        lut = qexact.input_lut
        with RecordConvs() as exact_rec, torch.inference_mode():
            qexact(gather_quantize_int8(slide[None], slide0, dense[:BS], PS, lut, "s2d4"),
                   pre_packed=True)
        with RecordConvs() as fcn_rec, torch.inference_mode():
            tiles = gather_quantize_int8(staged.tiles, torch.arange(FCN_TB, dtype=torch.int32),
                                         torch.zeros((FCN_TB, 2), dtype=torch.int32),
                                         staged.tiles.shape[1], lut, "s2d8_to_s2d4")
            tile_logits(qpack, tiles, FCN_HALO // 32, FCN_TILE // 32, qpack.fc_kernel,
                        pre_packed=True)
        return {"exact_int8_batch": exact_rec.calls,
                f"fcn_tile_batch_{FCN_TB}x{FCN_TILE + 2 * FCN_HALO}": fcn_rec.calls}

    k6_entry, k6_sums = check_k6(record_k6_calls())  # the recorded inputs go after it
    k6_entry["launches"] = 0
    k6_entry["launches_by_path"] = {}
    kernels.append(k6_entry)

    # 12. the exact int8 predict on the 16384^2 slide
    launches, runs, warm_s, best_s, peak_gib, exact_map = run_timed(
        lambda: predict_full_fused(slide, qexact, N_CLASSES),
        f"exact int8 predict, {MAIN_SIDE}^2, ResNet-18 s2d int8, batch {BS}", MAIN_SIDE)
    exact_map, exact_score = exact_map
    for name in ("gather_quantize_int8", "conv_int8", "scatter_add_map"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"the exact int8 path never launched {name}")
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
        k["launches_by_path"]["exact_int8_16384"] = launches.get(k["name"], 0) / runs
    exact_int8 = {"patches_per_s": n_patches / best_s, "best_s": best_s, "warm_s": warm_s,
                  "peak_gib": peak_gib, "k6_launches_per_predict": launches["conv_int8"] / runs}
    print(f"exact int8 path: {n_patches} patches in {best_s:.4f} s = "
          f"{n_patches / best_s:.1f} patches/s; K6 {launches['conv_int8'] // runs} launches a "
          f"predict; classes present {np.bincount(exact_map.ravel(), minlength=N_CLASSES).tolist()}")
    fused_prof = profile_device(lambda: predict_full_fused(slide, qexact, N_CLASSES))
    print(f"profile of one {MAIN_SIDE}^2 exact int8 predict: " + json.dumps(fused_prof))
    n_batches = -(-n_patches // BS)
    # the parent's input path (K1's uint8 gather, then the input quantize
    # and the s2d pack as torch ops): the same map and scores, and the
    # launches a batch it adds
    exact_int8["parent_input"] = parent_input_ab(
        lambda: predict_full_fused(slide, qexact, N_CLASSES), qexact, (exact_map, exact_score),
        fused_prof, n_batches, "exact int8 predict", n_patches)
    # the same predict with each block's epilogue as torch ops after K6's
    # f32 mode (the unfused composition): the same map, and the
    # torch launches the fused epilogue removes, by group
    with RecordConvs(record=False, unfused=True):
        _, _, _, unfused_s, _, unfused_out = run_timed(
            lambda: predict_full_fused(slide, qexact, N_CLASSES),
            "exact int8 predict, block epilogue as torch ops", MAIN_SIDE, runs=2)
        unfused_prof = profile_device(lambda: predict_full_fused(slide, qexact, N_CLASSES))
    if not np.array_equal(unfused_out[0], exact_map):
        raise AssertionError("the exact int8 map differs with the block epilogue as torch ops")
    per_batch = {g: {"fused": fused_prof["group_launches"].get(g, 0) / n_batches,
                     "unfused": unfused_prof["group_launches"].get(g, 0) / n_batches}
                 for g in sorted(set(fused_prof["group_launches"])
                                 | set(unfused_prof["group_launches"]))}
    exact_int8["unfused_epilogue"] = {"patches_per_s": n_patches / unfused_s, "best_s": unfused_s,
                                      "profile": unfused_prof}
    print(f"exact int8 launches a batch by group, fused block epilogue vs torch ops: "
          f"{json.dumps(per_batch)}; patches/s {n_patches / best_s:.1f} vs "
          f"{n_patches / unfused_s:.1f}")
    n_blocks = sum(qexact.stage_sizes)
    for g in ("residual / bias add", "relu / clamp", "dtype casts / copies"):
        if per_batch.get(g, {"fused": 0})["fused"] >= n_blocks:
            raise AssertionError(f"the fused exact int8 predict still launches {g} kernels per "
                                 f"residual block: {per_batch[g]}")
    crop = slide[:INT8_CHECK_SIDE, :INT8_CHECK_SIDE].contiguous()
    int8_vs_plain(lambda: predict_full_fused(crop, qexact, N_CLASSES),
                  f"exact int8 predict on a {INT8_CHECK_SIDE}^2 crop")

    # 13. the fcn serving mode on the 16384^2 slide: bench.py's headline
    # (pack 8, pre-tiled, pack_l1), then its pack-4 int8 and bf16 rows
    n_equiv = fcn_equivalent_patches(MAIN_SIDE, MAIN_SIDE)

    def fcn_row(label, staged_slide, model, s_s):
        launches, runs, warm_s, best_s, peak_gib, out = run_timed(
            lambda: predict_full_fcn(staged_slide, model, N_CLASSES, tile=FCN_TILE,
                                     halo=FCN_HALO, tile_batch=FCN_TB), label, MAIN_SIDE)
        agree = float((out[0] == exact_map).mean())
        row = {"equivalent_patches_per_s": n_equiv / best_s, "best_s": best_s, "warm_s": warm_s,
               "stage_s": s_s, "peak_gib": peak_gib, "agreement_with_exact_int8": agree,
               "launches_per_predict": {k: v / runs for k, v in launches.items() if v}}
        print(f"{label}: {n_equiv} equivalent patches in {best_s:.4f} s = {n_equiv / best_s:.1f} "
              f"patches/s; staging {s_s:.3f} s; argmax agreement with the exact int8 map {agree}")
        return launches, runs, row

    launches, runs, headline = fcn_row("fcn_int8_pack8_staged (headline)", staged, qpack, stage_s)
    for name in ("gather_quantize_int8", "conv_int8"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"the fcn path never launched {name}")
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
        k["launches_by_path"]["fcn_int8_16384"] = launches.get(k["name"], 0) / runs

    def headline_fn():
        return predict_full_fcn(staged, qpack, N_CLASSES, tile=FCN_TILE, halo=FCN_HALO,
                                tile_batch=FCN_TB)

    headline_prof = profile_device(headline_fn)
    print(f"profile of one {MAIN_SIDE}^2 fcn predict (headline): " + json.dumps(headline_prof))
    headline_out = headline_fn()
    headline["parent_input"] = parent_input_ab(
        headline_fn, qpack, headline_out, headline_prof, -(-staged.tiles.shape[0] // FCN_TB),
        "fcn headline predict", n_equiv)
    headline["b6"] = time_b6(device)
    # K6's designs end to end, in turns: every conv on the mma.sync kernel
    # against the chooser's wgmma kernel at Cin % 64 == 0
    ab = design_ab(record_k6_calls(), {
        "exact_int8": (lambda: predict_full_fused(slide, qexact, N_CLASSES), n_patches),
        "fcn_headline": (lambda: predict_full_fcn(staged, qpack, N_CLASSES, tile=FCN_TILE,
                                                  halo=FCN_HALO, tile_batch=FCN_TB), n_equiv)})
    print(f"K6 designs, in turns (mma.sync everywhere vs conv_design): {json.dumps(ab)}")
    k6_entry["design_ab"] = ab
    del staged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged4 = stage_for_fcn(slide, tile=FCN_TILE, halo=FCN_HALO)
    torch.cuda.synchronize()
    stage4_s = time.perf_counter() - t0
    rows = {"fcn_int8_pack8_staged": headline}
    launches, runs, rows["fcn_int8_pack4_staged"] = fcn_row("fcn_int8_pack4_staged", staged4, qpack,
                                                            stage4_s)
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)
        k["launches_by_path"]["fcn_int8_pack4_16384"] = launches.get(k["name"], 0) / runs
    rows["fcn_bf16_staged"] = fcn_row("fcn_bf16_staged", staged4, r18, stage4_s)[2]
    del staged4
    crop_staged = stage_for_fcn(crop, tile=FCN_TILE, halo=FCN_HALO, pack=8, pre_tile=True)
    int8_vs_plain(lambda: predict_full_fcn(crop_staged, qpack, N_CLASSES, tile=FCN_TILE,
                                           halo=FCN_HALO, tile_batch=FCN_TB),
                  f"fcn headline predict on a {INT8_CHECK_SIDE}^2 crop")
    print("int8 paths: " + json.dumps({"exact_int8": exact_int8, "fcn": rows}))
    del qexact, qpack, r18, crop, crop_staged, slide

    # 14. training main path: vit2p8 through make_fused_epoch over the sampler
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

    # 15. the vit2p8 step vs the plain attention; the one-batch overfit
    vit_step_vs_plain(state.model, sampler, device)

    # 16. ResNet-18 training through the same epoch
    r18 = init_model(get_model(N_CLASSES, depth=18, stem="s2d"), seed=SEED).to(device)
    stats0 = r18.bn1.running_mean.clone(), r18.bn1.running_var.clone()
    _, r18_step, _, _, _ = run_training("ResNet-18 (s2d)", r18, sampler, 1e-3, 0.0, 0, 0.0)
    if torch.equal(stats0[0], r18.bn1.running_mean) or torch.equal(stats0[1], r18.bn1.running_var):
        raise AssertionError("ResNet-18 training left the BatchNorm running statistics as they were")
    for k in kernels:
        k["launches"] += int(round(r18_step.get(k["name"], 0) * TRAIN_EPOCHS * TRAIN_STEPS))
        k["launches_by_path"]["resnet18_train_step"] = r18_step.get(k["name"], 0)
    del r18

    # 17. where a vit2p8 train step's time goes, with the qkv gradient as
    # K5/K4 write it (flash_attention_qkv) and, in turns, as the parent took
    # it (three selects of qkv, whose backward fills and adds copies)
    one = make_fused_epoch(state.model, sampler, BS, 1, crop_pad=TRAIN_CROP, label_smoothing=0.1)
    gen = torch.Generator().manual_seed(SEED + 9)
    print(f"qkv split A/B of one vit2p8 train step: {json.dumps(qkv_split_ab(one, state, gen))}")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
