"""Smoke test of the PyTorch + CUDA port (``deephisto_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It imports nothing
of JAX or of the JAX package. Phases, any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: every kernel under ``deephisto_tpu_torch/csrc`` with ``nvcc``,
   and the native host library (``deephisto_tpu_torch/native``) with
   ``g++``, before any timed phase whose host gathers take it;
3. kernels vs their plain PyTorch versions on the card at the main path's
   shapes: K1 (gather + /255) bit-equal in f32 and bf16; K1's int8 mode
   (the int8 model's input quantize and stem layout fused into the gather)
   bit-equal in its three layouts at the int8 paths' shapes (s2d4: an exact
   batch; s2d8_to_s2d4: an fcn headline step; hwc: an fcn pack-4 step, the
   int8 ViT's exact batch, a PackedSlide batch, and on the raw 3-channel
   slide a batch of 64 windows of 224² and a step of 16 tiles of 1152², the
   predict CLI's ``--int8`` and ``--int8 --fcn`` calls), timed beside its
   byte bound, PR 9's kernel's reading and the parent's composition (the
   uint8 gather or tile copy, the quantize and the pack as torch ops); K2 (stitch) bit-equal to the sequential loop and identical
   from run to run (the main path's batches, spans, the map's last rows, a
   wrapping batch, N = 1 and 2,000, a band of one tile row, and the random
   predicts' coverage accumulator: (8192/16)² × 1, footprint 15, batch 64,
   corners at the bottom and right edges), timed beside its byte bound, the
   library call and an empty launch on its grid;
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
    kernel group (launches and time);
18. the training program on the same slides (under a folder without the
    synthetic marker): ``main(["--extract_test", "--config", ...])`` of
    ``deephisto_tpu_torch.models.patch_cls_simple.train`` with
    ``config_vit.yaml`` (ViT-S/16, depth 6, 196 tokens, batch 64, AdamW,
    warmup-cosine) cut to 2 epochs of 10 steps, 2 validation steps and 16
    test patches a class, then ``--resume`` to 3 epochs: K1's multi-slide
    mode 1 and K3, K5, K4 6 each a training step, the files written, one
    resumed epoch numbered 3, 3 rows in ``metrics.csv``; one step of the
    trained ViT-S/16 (batch 64, 196 tokens) with K3-K5 against the same step
    with the plain attention (loss and every parameter's gradient), then 8
    steps on that batch; ``best_model.msgpack`` read by the port's
    ``load_model`` into a fresh ViT serves a 2048² crop of the seeded slide
    through ``predict_full_fused`` with the map and scores of a fresh ViT
    holding the tensors the trainer's last ``save_model`` was given, copied
    in memory at that call (no codec, no weight bridge); each epoch's
    patches/s beside a bare ``make_fused_epoch`` of the same model and
    batch, the seconds of extraction, validation, test, CSV, plots and each
    checkpoint write and read, the checkpoint bytes, and an epoch's busy
    share under the profiler;
19. ``benchmarks/config_ctx64.yaml`` (ResNet-18, context 64, 352² windows)
    for 1 epoch of 10 steps, its checkpoint served by ``predict_full_fcn``
    (bf16) and ``predict_full_fused`` on the crop with the maps and scores
    of the tensors its ``save_model`` was given, and the share of map cells where the two agree; and
    ``config_resnet50_multimag.yaml`` (ResNet-50 on 9 channels, layers 1, 2,
    4) for 1 epoch of 10 steps: 3 K1 launches a step, BatchNorm statistics
    moved;
20. the predict CLI (``deephisto_tpu_torch.examples.predict_full_patched``)
    at its own settings (layer 2 of phase 4's slide written as a DHS
    dataset, so an 8192² input, batch 64, downscale 16) from a checkpoint of
    the seeded ResNet-18 written by ``save_model``, in each mode: random
    (default), ``--dense``, ``--host_loop`` (random and dense), ``--int8``
    (random and dense) and ``--int8 --fcn``, then the dense sampler in
    ONDISK mode through ``process_on_device``. Each: the kernels it
    launched (K1 and K2 on the fused modes, K6 under ``--int8``) and no
    call of a plain version, the three JPEGs (512², the overlay by its
    formula), patches/s, peak memory, busy share (its predict call again
    under the profiler; the host loops timed under it, not on the host
    clock), the host syncs torch sees in a fused predict call
    (``torch.cuda.set_sync_debug_mode``), the host seconds of the layer-1
    resize and the JPEG writes. ``--dense`` and ``--int8 --dense`` bit-equal
    to ``predict_full_fused`` with the same arguments; random and ``--int8``
    random at filled 1.0 within ``max_steps``, every coverage cell ≥ 1,
    their maps, scores and coverage bit-equal to a replay of their own draws
    through the plain K1 and K2 (and, for the int8 model, K1's plain int8
    mode and K6's plain version); K6 against its plain version on every
    conv of one ``--int8 --dense`` batch (64 × 224², the imagenet stem's
    7×7/2 on 3 channels included) and of one ``--int8 --fcn`` tile batch
    (16 × 1152²) of the CLI's quantized model, in its own mode and in the
    f32 and int8 modes, bit-equal, two runs identical; ``--host_loop`` dense
    against ``--dense`` ≥ 99.9 % of cells; the fcn map's agreement with
    exact int8 (reported);
21. the serving daemon (``deephisto_tpu_torch.serve``): a ``save_model``
    checkpoint and config YAML of phase 11's seeded s2d ResNet-18 (its head
    centred), served by a float and an ``int8=True`` ``ServingEngine``
    (``from_checkpoint``, the engine's defaults: tile 1024, halo 32, 16
    tiles a step, 8 patch lanes) behind ``serve_in_thread``: ``/healthz``
    names the card; the 16384² slide POSTed as ``.npy`` to ``/v1/slide`` in
    fcn, dense and random mode, each map bit-equal to the direct call with
    the same arguments, then ``/v1/stage`` and the fcn request by key,
    bit-equal to the unstaged map; ``/v1/patch`` from 1 client and from 64
    at once (4 requests each), each answer's class equal and its
    probabilities within 1e-5 of the direct 8-lane forward; request
    seconds, patches/s over HTTP and direct, the HTTP overhead and
    requests/s; both streamed predicts at 16384² with 2,048 stripe rows
    (dense bf16 and int8, fcn int8 pack 8 and bf16) bit-equal to the
    resident ones (maps and scores), timed in turns with the share of the
    upload hidden (``prestage_all``'s ``timings``), and the int8 engine
    with ``stream_above_bytes`` under the slide's size routing fcn to the
    streamed predict with the same map; then on phase 7's 8192² crop
    vit2p8 through ``fold_vit_stem`` (map agreement and score gap with the
    unfolded bf16 model; against the float32 model on the 2048² crop its
    agreement at most 1 point under the unfolded bf16 model's and its
    largest score gap at most twice that model's), ``quantize_vit`` of
    vit2p8 (conv stem) and ViT-S/16 (linear stem) on 32 patches of the
    slide: K6 bit-equal to its plain version on every conv of one int8
    batch of 256 (its own mode, f32 and int8), every ``_int_mm`` Dense of
    that batch bit-equal to its float64 product, each timed beside its
    bound; the bf16, folded and int8 predicts timed with K3 launched depth
    × batches a predict. Every kernel (K1 in its three modes, K2, K3, K6)
    launched on the phase's paths, and no plain version called there (the
    kernels', the int8 Dense's, K3's and the ViT's plain attention). Also
    B7 (``gumbel_topk``, ``coverage_cell_topk``, torch ops) timed apart at
    the random predicts' shapes beside its byte bound;
22. the parallel paths (``deephisto_tpu_torch.parallel``). World 1 over
    NCCL (``parallel.initialize`` on a one-rank file store): the 16384²
    bf16 ResNet-18 through ``predict_full_fused(mesh=)`` and
    ``predict_full_spatial`` bit-equal to ``predict_full_fused``, phase 13's
    headline int8 model through ``predict_full_fcn_spatial`` (host-packed
    s2d8 bands) bit-equal to ``predict_full_fcn``, both routes from the same
    host array (the single one through ``stage_for_fcn``'s host pack; the
    pre-staged headline timed beside them), and data-parallel bf16 vit2p8
    and ResNet-18 (s2d, phase 16's) steps at the training path's batch of
    256 equal to the single steps, each timed beside its single call in
    turns, with the mesh route's overhead and its busy share under the
    profiler; then
    ``make_fused_epoch(mesh=)`` of phase 16's recipe in f32 (crop and flips,
    presampled and sampling every step) against the single epoch (losses
    within rtol 2e-4, correct counts equal, K1's multi mode launched). Then
    2 ranks over gloo sharing the card (``torch.multiprocessing``, the
    kernels built once before), each rank launching its kernels: the three
    predicts against world 1 (argmax equal; DP scores within 1e-5 of the
    largest |score|, fcn scores within 1e-5), ResNet-18 and vit2p8
    data-parallel steps at batch 256 against world 1 (f32 with TF32 off
    over 2 steps: rtol 2e-4; bf16, 1 step: the loss within ``LOSS_DIFF``),
    the two fused epochs against the single ones (as at world 1), a
    tensor-parallel vit2p8 step (BN conv stem) and a 2-stage pipeline step
    of vit2p8 with the GroupNorm stem (8 microbatches of 32) at batch 256
    against the single step in f32 (the loss within 1e-5 relative, every
    gradient within 1e-4); the CUDA tensors' hops host-staged under gloo
    (the explicit branch ``parallel/_comm.py:host_staged``), and each
    path's launches by rank. A failure in any rank fails the phase;
23. the long tail: phase 4's ResNet-18 and phase 7's vit2p8 (bf16) and
    phase 11's int8 ResNet-18 (s2d) through ``export_classifier`` at batch
    256 × 224² on the card, each loaded from its bytes and fed one
    K1-gathered batch of the 16384² slide: the int8 program bit-equal to
    the live model, the bf16 ones at phases 5 and 8's argmax limits, K3
    launched 6 times a batch by the loaded ViT and K6 20 times by the
    loaded int8 program (the registered ops), each as often as the live
    model launches it; loaded and live patches/s (best of 3, in turns) and
    the artifact's bytes. ``train/dist_ckpt.py`` at world 1: a vit2p8 bf16
    train state after 3 steps at batch 256 saved async, 2 more steps during
    the write (the seconds the save blocks and the write's), a fresh state
    restored from it taking the same 2 steps bit for bit (losses and every
    parameter; cuDNN deterministic), three saves with ``max_to_keep=2``
    leaving the last two; ``ServingEngine.from_checkpoint`` over a
    checkpoint directory of the s2d ResNet-18 serving the 8192² crop's fcn
    and dense maps bit-equal to the same weights' msgpack; 2 ranks over gloo
    on the card (``ckpt_rank``): a tensor-parallel (model=2) f32 vit2p8
    state whose replicas (parameters, BatchNorm statistics, moments) are
    bit-equal on both ranks after its step, cuDNN in its default mode; it
    and a 2-stage pipeline f32 vit2p8 state restored at world 1 bit-equal to their
    canonical gathers, a data-parallel save restored bit-equal and holding
    each replica once (its bytes within 5 % of a world-1 save); a
    ``profiling.trace`` of one vit2p8 predict of the 2048² crop that names
    the ``annotate`` region and K3's kernel, ``StageTimer`` with ``sync=``
    at least the CUDA events' time of the same call; the native library
    built on this machine, its clip areas within 1e-9 of the box's area of
    numpy's over the synthetic dataset's regions and 4,096 seeded boxes, its
    patch extraction equal to numpy slicing with clamped corners, each
    timed beside numpy.

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
bf16 Dh 64), and timed at Dh 16, 32 and 128 too; K3, K4 and K5 are also
held at (64, 6, 196, 64), the ViT-S/16 training program's step; and K1's
multi-slide uint8 mode bit-equal to its plain version at the training
bank's shape and at the training program's: 64 windows of 224 and 352 px
on the layer-2 bank, 64 of 224 px on the layer-1 and layer-4 banks.

It prints the card line, then one ``{"kernels": [...]}`` line, then as its
last line ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import copy
import importlib
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
# (64, 6, 196, 64): the ViT-S/16 training program's step (phase 18)
K3_SHAPES = [(256, 6, 784, 64), (8, 6, 1000, 64), (256, 6, 196, 64), (64, 6, 196, 64),
             (16, 6, 300, 16), (16, 6, 300, 32)]
# K4/K5 vs their plain version: bf16 gradients within 2 % of the largest
# |gradient| (P and dS round to bf16 before their products against the
# kernels' and the plain version's own roundings of S); f32 within 1e-4
K45_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
K45_SHAPES = [(256, 6, 784, 64), (8, 6, 1000, 64), (64, 6, 196, 64), (16, 6, 300, 16),
              (16, 6, 300, 32), (8, 6, 300, 128)]
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

    # the random predicts' coverage accumulator (phase 20's shape): a
    # (8192/16)² × 1 map of counts, footprint 15, batch 64, a quarter of the
    # corners each at the bottom edge, the right edge and the bottom-right
    # corner, their cells past the edges dropped
    cov = PRED_SIDE // 16
    q = PRED_BS // 4
    near = lambda: rng.integers(cov - 15, cov, q)  # noqa: E731
    anywhere = lambda: rng.integers(0, cov, q)  # noqa: E731
    cov_cds = torch.from_numpy(np.concatenate([
        np.stack([near(), anywhere()], 1), np.stack([anywhere(), near()], 1),
        np.stack([near(), near()], 1), np.stack([anywhere(), anywhere()], 1)]).astype(np.int32))
    cov_cds = cov_cds.to(device)
    ones = torch.ones((len(cov_cds),), device=device)
    cov_base = torch.randint(0, 3, (cov, cov, 1), device=device, generator=gen).float()
    runs = [scatter_add_map(cov_base.clone(), cov_cds, ones, PS // 16 + 1) for _ in range(2)]
    torch.cuda.synchronize()
    want = scatter_add_map_ref(cov_base.clone(), cov_cds, ones, PS // 16 + 1)
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], want)):
        raise AssertionError("K2 differs from its plain version on the coverage accumulator")
    cov_ms = cuda_ms(lambda i: scatter_add_map(cov_base, cov_cds, ones, PS // 16 + 1), 50)
    print(f"K2 scatter_add_map [coverage {cov}x{cov}x1, f {PS // 16 + 1}, batch {len(cov_cds)}, "
          f"corners at the bottom and right edges]: bit-equal to the plain loop, two runs "
          f"identical; {cov_ms:.4f} ms")

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
        "coverage_batch_ms": cov_ms,
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
    """K1's multi-slide uint8 mode bit-equal to the plain gather (starts
    clamped as lax.dynamic_slice does, some out of range) at the training
    paths' shapes: 3 slides of 3072² plus the bank's slack at layer 2 with
    256 windows of 224 + 2·16 px (the vit2p8 epoch), 64 of 224 px (the
    ViT-S/16 CLI) and 64 of 224 + 2·64 px (the ctx64 CLI), and 64 windows of
    224 px on the multi-magnification banks of layers 1 and 4; timed at the
    first shape."""
    from deephisto_tpu_torch.ops import gather_multi_u8, gather_patches_multi
    from deephisto_tpu_torch.samplers.bank import SLACK_COLS, SLACK_ROWS

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)

    def check(layer, win, n):
        side = TRAIN_SIDE // layer
        shape = (3, side + SLACK_ROWS, side + SLACK_COLS, 3)
        bank = torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)
        batches = []
        for _ in range(8):
            idx = rng.integers(0, 3, n).astype(np.int32)
            coords = rng.integers(0, side - win + 1, (n, 2)).astype(np.int32)
            batches.append((torch.from_numpy(idx).to(device), torch.from_numpy(coords).to(device)))
        idx, coords = (t.clone() for t in batches[0])
        idx[:2] = torch.tensor([-1, 5])
        coords[:3] = torch.tensor([[-7, 3], [shape[1], shape[2]], [side - win, side - win]])
        got = gather_multi_u8(bank, idx, coords, win)
        torch.cuda.synchronize()
        if not torch.equal(got, gather_patches_multi(bank, idx, coords, win)):
            raise AssertionError(f"K1's multi-slide mode differs from its plain version at N={n}, "
                                 f"window {win}, bank {shape}")
        print(f"K1 gather_multi_u8: bit-equal to the plain gather at N={n}, window {win}, "
              f"bank {shape} (layer {layer})")
        return bank, batches

    win = PS + 2 * TRAIN_CROP
    bank, batches = check(TRAIN_LAYER, win, BS)
    for layer, w, n in ((TRAIN_LAYER, PS, 64), (TRAIN_LAYER, PS + 2 * 64, 64), (1, PS, 64),
                        (4, PS, 64)):
        check(layer, w, n)
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


# K1's int8 mode as PR 9 wrote it (one block a window and a few row groups,
# staging and look-ups in turn), on the H100 80GB HBM3 at 700 W (PERF.md §6):
# ms a call at each timed row
PR9_INT8_MS = {"exact_s2d4": 0.0533, "fcn_headline_s2d8_to_s2d4": 0.0590, "fcn_pack4_hwc": 0.0486}


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
      cells of 48 bytes), and the int8 ViT's call, the exact path's 256
      windows of 224² as they are; checked only: a ``PackedSlide`` batch
      (256 windows of 56² cells) and, on the raw 3-channel slide, the
      predict CLI's imagenet-stem calls: ``--int8`` (64 windows of 224²)
      and ``--int8 --fcn`` (16 tiles of 1152² at the tile grid's corners).

    Each timed row is printed beside the PR 9 kernel's reading on the same
    card (H100 80GB HBM3 at 700 W, ``PR9_INT8_MS``) and with its share of
    its byte bound, and with the kernel's plan (``ops/gather.py:int8_launch_plan``)."""
    from deephisto_tpu_torch.ops import (
        gather_multi_u8,
        gather_quantize_int8,
        gather_quantize_int8_ref,
        s2d_pack4,
        unpack_s2d8,
    )
    from deephisto_tpu_torch.ops.gather import int8_launch_plan
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
        "vit_hwc": (slide[None], [one] * n_exact,
                    [dense[i * BS:(i + 1) * BS].numpy() for i in range(n_exact)], PS, "hwc",
                    lambda b, s, c: quantize_ops(gather_multi_u8(b, s, c, PS), inv0)),
    }
    packed_slide = stage_packed_slide(slide, keep_raw=False, device=device).packed
    checks = [(b, s[0], c[0], ps, lay) for b, s, c, ps, lay, _ in cases.values()]
    checks.append((packed_slide[None], one, dense[:BS].numpy() // 4, PS // 4, "hwc"))
    checks.append((slide[None], one[:PRED_BS], dense[:PRED_BS].numpy(), PS, "hwc"))
    checks.append((slide[None], np.zeros(FCN_TB, np.int32), tile_batch(0)[1] * 4,
                   FCN_TILE + 2 * FCN_HALO, "hwc"))
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
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        plan = int8_launch_plan(bank, layout, ps)
        out[name] = {"layout": layout, "ms": ms, "plain_ms": plain_ms, "parent_ms": parent_ms,
                     "bound_ms": bound, "share_of_bound": bound / ms, "windows": len(coordss[0]),
                     "window": ps, "bank": list(bank.shape), "plan": plan}
        pr9 = (f"; PR 9's kernel {PR9_INT8_MS[name]:.4f} ms ({bound / PR9_INT8_MS[name]:.0%})"
               if name in PR9_INT8_MS else "")
        print(f"K1 gather_quantize_int8 [{name}]: {ms:.4f} ms against its byte bound "
              f"{bound:.4f} ms ({bound / ms:.0%} of it){pr9}; the parent's composition "
              f"{parent_ms:.4f} ms; plain {plain_ms:.4f} ms; plan {json.dumps(plan)}")
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
                "steps and the int8 ViT's hwc call", "by_layout": out,
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


def profile_device(fn, cpu: bool = True) -> dict:
    """Device time of ``fn()`` by kernel group, and the card's busy share
    (union of kernel intervals over the profiled wall time). ``cpu=False``
    traces the card only (no host operators: a cheaper trace of a long
    host loop). A trace that holds no device event (the tracer sometimes
    drops a trace of a few tens of µs) is taken again, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
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
        if spans:
            break
        print(f"profile_device: trace {attempt + 1} of {wall_us:.0f} µs holds no device event")
    else:
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


def vit_step_vs_plain(model, sampler, device, label="vit2p8"):
    """One train-mode loss and gradient of ``model`` on one sampled batch
    with K3-K5, and with the plain attention (FLASH_MIN_SEQ raised), from
    copies of the same weights; then 8 optimizer steps on that batch."""
    import copy

    from deephisto_tpu_torch import _build
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

    before = dict(_build.launches)
    loss, grads = loss_and_grads()
    torch.cuda.synchronize()
    depth = model.depth
    launched = {k: _build.launches.get(k, 0) - before.get(k, 0) for k in (
        "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    if set(launched.values()) != {depth}:
        raise AssertionError(f"the {label} step launched {launched}, not {depth} of each")
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
    print(f"{label} train step with K3-K5 ({launched}) vs the plain attention (batch {n}): loss "
          f"{float(loss):.6f} vs {float(loss_p):.6f} (|diff| {dloss:.3g}, bound {LOSS_DIFF}); "
          f"per-tensor ||g - g'||/||g'|| max {rel[worst]:.3g} at {worst} (bound {GRAD_REL}), "
          f"median {float(np.median(list(rel.values()))):.3g} over {len(rel)} tensors")
    if dloss > LOSS_DIFF or rel[worst] > GRAD_REL:
        raise AssertionError(f"the {label} step with K3-K5 disagrees with the plain attention")

    m = copy.deepcopy(model)
    state = create_train_state(m, 3e-4, weight_decay=0.05)
    train_step, _ = make_steps(m)
    losses = []
    for _ in range(8):
        state, l, _ = train_step(state, x, labels)
        losses.append(l)
    losses = torch.stack(losses).tolist()
    print(f"{label} overfit of one batch of {n}: losses over 8 steps {[round(v, 4) for v in losses]}")
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


def check_k6_call(mode, args) -> dict:
    """K6 against its plain version on one recorded call: in its own mode (a
    block call in its residual kind and output) and in both f32 and int8
    modes, bit-equal (by value), two runs identical. Returns the outputs by
    mode."""
    x, w, stride = args[:3]
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
    return outs


def check_k6(calls_by_path: dict) -> tuple[dict, dict]:
    """K6 against its plain version on the recorded calls of each path (the
    convs of one batch of the exact path and of one tile batch of the fcn
    path; ``check_k6_call``); each distinct call timed in its own mode beside its bound,
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
            x, w, stride, pads = args[:4]
            outs = check_k6_call(mode, args)
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
    (inputs read once, outputs written once), with its kernel launches a
    call (counted in one trace of 20 calls)."""
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
    out, reps = {}, 20
    for name, (fn, nbytes) in calls.items():
        prof = profile_device(lambda: [fn(i) for i in range(reps)])
        out[name] = {"ms": cuda_ms(fn, 20), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "launches": sum(prof["group_launches"].values()) / reps}
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


# ---- the training program (phases 18-19) --------------------------------

CLI_MODULE = "deephisto_tpu_torch.models.patch_cls_simple.train"
CLI_EPOCHS, CLI_STEPS, CLI_VAL_STEPS, CLI_TEST_PER_CLASS = 2, 10, 2, 16
CLI_CROP = 2048  # the seeded slide's crop the trained checkpoints serve


def yaml_lines(cfg: dict, indent: str = "") -> list[str]:
    """A config of nested maps, scalars and lists as block YAML lines."""
    lines = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            lines += [f"{indent}{k}:"] + yaml_lines(v, indent + "  ")
        else:
            lines.append(f"{indent}{k}: {yaml_scalar(v)}")
    return lines


def yaml_scalar(v) -> str:
    """``v`` as YAML 1.1 reads it back: a float always with a dot (``1e-05``
    would read as a string), strings quoted."""
    if isinstance(v, float):
        mant, _, exp = repr(v).partition("e")
        return (mant if "." in mant else mant + ".0") + (f"e{exp}" if exp else "")
    if isinstance(v, list):
        return "[" + ", ".join(yaml_scalar(x) for x in v) + "]"
    return json.dumps(v)


def write_yaml(path: Path, cfg: dict) -> None:
    path.write_text("\n".join(yaml_lines(cfg)) + "\n")


class TrainSpy:
    """While active, wraps the trainer module's epoch and eval factories and
    its host-side steps: the seconds of each call by name (after a
    synchronize), each training epoch's seconds and launches (deltas of
    the launch counts, which it does not reset), and at each ``save_model``
    a copy of the saved model's tensors as they stood in memory (``saves``:
    (path, the epochs trained so far, state dict on the card))."""

    TIMED = ("prepare_test_patches", "_test_pass", "save_plot", "append_metrics",
             "save_model", "save_train_state", "load_train_state")

    def __init__(self):
        import importlib

        self.mod = importlib.import_module(CLI_MODULE)
        self.seconds: dict[str, list[float]] = {}
        self.epochs: list[dict] = []
        self.saves: list[tuple[Path, int, dict]] = []
        self.last_epoch = None

    def _timed(self, name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    def _epoch_factory(self, factory):
        from deephisto_tpu_torch import _build

        def make(*a, **k):
            epoch_fn = factory(*a, **k)
            n_steps = a[3] if len(a) > 3 else k["n_steps"]

            def run(state, gen):
                before = dict(_build.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = epoch_fn(state, gen)  # returns after its one read back
                secs = time.perf_counter() - t0
                self.epochs.append({"seconds": secs, "steps": n_steps, "launches": {
                    n: v - before.get(n, 0) for n, v in _build.launches.items()
                    if v - before.get(n, 0)}})
                self.last_epoch = (epoch_fn, state)
                return out
            return run
        return make

    def _save_model(self, save):
        def call(path, model):
            out = save(path, model)
            inner = getattr(model, "inner", model)  # a ContextWindowModel saves its base
            self.saves.append((Path(path), len(self.epochs), {
                k: v.detach().clone() for k, v in inner.state_dict().items()}))
            return out
        return call

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in
                      self.TIMED + ("make_fused_epoch", "make_fused_eval")}
        for n in self.TIMED:
            setattr(self.mod, n, self._timed(n, self.saved[n]))
        self.mod.save_model = self._save_model(self._timed("save_model", self.saved["save_model"]))
        setattr(self.mod, "make_fused_epoch", self._epoch_factory(self.saved["make_fused_epoch"]))
        ev = self.saved["make_fused_eval"]
        setattr(self.mod, "make_fused_eval", lambda *a, **k: self._timed("validation", ev(*a, **k)))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)

    def per_step(self, first: int = 0) -> dict:
        """Launches a step over the epochs from index ``first`` on."""
        steps = sum(e["steps"] for e in self.epochs[first:])
        total: dict[str, float] = {}
        for e in self.epochs[first:]:
            for n, v in e["launches"].items():
                total[n] = total.get(n, 0) + v
        return {n: v / steps for n, v in total.items()}


def run_cli(argv: list, label: str, batch: int):
    """``main(argv)`` of the training program under a TrainSpy, every launch
    count set to 0 just before and read just after. Returns (result, spy,
    launches, seconds)."""
    from deephisto_tpu_torch import _build

    with TrainSpy() as spy:
        _build.reset_launches()
        t0 = time.perf_counter()
        result = spy.mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.launches)
    print(f"{label}: main({argv[:-2]}) in {secs:.2f} s; epochs "
          + ", ".join(f"{e['steps'] * batch / e['seconds']:.1f} patches/s" for e in spy.epochs)
          + f"; host steps (s) {json.dumps(spy.seconds)}")
    return result, spy, launches, secs


def cli_config(name: Path, root: Path, tag: str, **training) -> tuple[dict, Path]:
    """The config file ``name`` with the phases' epochs and steps, its paths
    in ``root``: (config, path of the written copy)."""
    from deephisto_tpu_torch.models.patch_cls_simple.utils import load_config

    cfg = load_config(name)
    cfg["training"].update({"n_epochs": CLI_EPOCHS, "train_steps": CLI_STEPS,
                            "val_steps": CLI_VAL_STEPS, "save_dir": str(root / f"checkpoints_{tag}"),
                            "out_dir": str(root / f"output_{tag}"), **training})
    cfg["test"].update(dir=str(root / "test"), samples_per_class=CLI_TEST_PER_CLASS)
    cfg["dataset"]["folder"] = str(root / "dataset")
    path = root / f"config_{tag}.yaml"
    write_yaml(path, cfg)
    return cfg, path


def served_maps(model, crop, fcn: bool):
    from deephisto_tpu_torch.predict import predict_full_fcn, predict_full_fused

    with torch.inference_mode():
        if fcn:
            out = predict_full_fcn(crop, model, N_CLASSES, tile=FCN_TILE, halo=FCN_HALO)
        else:
            out = predict_full_fused(crop, model, N_CLASSES)
    return out[0], out[1].clone()


def same_maps(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def fresh_model(cfg: dict):
    """A new base model of ``cfg`` (a ctx model's inner ResNet), on the host."""
    from deephisto_tpu_torch.models.patch_cls_simple import get_model

    m = cfg["model"]
    return get_model(N_CLASSES, depth=m.get("depth", 18), arch=m.get("arch", "resnet"),
                     stem=m.get("stem", "imagenet"), width=m.get("width", 1),
                     patch=m.get("patch", 16))


def checkpoint_model(cfg: dict, path: Path, device):
    """A fresh model of ``cfg`` with the weights of the checkpoint at ``path``
    (the port's load_model), on the card in eval mode; and the read's seconds."""
    from deephisto_tpu_torch.train import load_model, load_variables

    model = fresh_model(cfg)
    t0 = time.perf_counter()
    variables = load_model(path)
    read_s = time.perf_counter() - t0
    return load_variables(model, variables).to(device).eval(), read_s


def saved_in_memory(cfg: dict, saves: list, path: Path, device):
    """A fresh model of ``cfg`` holding the tensors that the last
    ``save_model`` to ``path`` was given, as they stood in memory (no
    checkpoint codec, no weight bridge), on the card in eval mode; and the
    epochs trained before that save."""
    _, epoch, state_dict = [x for x in saves if x[0] == path][-1]
    model = fresh_model(cfg)
    model.load_state_dict(state_dict)
    return model.to(device).eval(), epoch


def host_op_ms(fn, top: int = 15) -> dict:
    """The host's self time of ``fn()`` by operator (ms), the largest first:
    where a host-bound loop spends its time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return {f"{e.key} x{e.count}": e.self_cpu_time_total / 1e3 for e in rows}


def train_cli_phase(root: Path, sampler, device) -> dict:
    """Phases 18 and 19 (module docstring). Returns the numbers, with
    ``launches`` {path: (the run's launches, launches a training step)}."""
    import importlib.util

    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model, make_fused_epoch
    from deephisto_tpu_torch.train import create_train_state

    pkg = Path(__file__).resolve().parent / "deephisto_tpu_torch/models/patch_cls_simple"
    ds = root / "dataset"  # the phases' slides under a folder without the
    ds.mkdir()  # synthetic marker, which resolve_dataset would remake
    for sub in ("images", "annotations"):
        (ds / sub).symlink_to(root / "synthetic_hard" / sub)
    out: dict = {"launches": {}}

    # 18. ViT-S/16 through the CLI: extract + 2 epochs, then resume for 1
    cfg, path = cli_config(pkg / "config_vit.yaml", root, "vit")
    bs = cfg["training"]["batch_size"]
    res1, spy1, l1, s1 = run_cli(["--extract_test", "--config", str(path)], "ViT-S/16 CLI", bs)
    cfg["training"]["n_epochs"] = CLI_EPOCHS + 1
    write_yaml(path, cfg)
    res2, spy2, l2, s2 = run_cli(["--resume", "--config", str(path)], "ViT-S/16 CLI, resumed", bs)
    launches = {n: l1.get(n, 0) + l2.get(n, 0) for n in set(l1) | set(l2)}
    spy2.epochs = spy1.epochs + spy2.epochs
    per_step = spy2.per_step()
    want = {"gather_multi_u8": 1, "flash_attention": VIT_DEPTH,
            "flash_attention_bwd_dkv": VIT_DEPTH, "flash_attention_bwd_dq": VIT_DEPTH}
    got = {k: per_step.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"the ViT-S/16 CLI epoch launched {got} a step, not {want}")
    out["launches"]["train_cli_vit_s16"] = (launches, per_step)
    out_dir, save_dir = Path(cfg["training"]["out_dir"]), Path(cfg["training"]["save_dir"])
    test_files = sorted(Path(cfg["test"]["dir"]).glob("*/*.jpg"))
    rows = (out_dir / "metrics.csv").read_text().splitlines()
    plots = importlib.util.find_spec("matplotlib") is not None  # the trainer plots if so
    missing = [f for f in (out_dir / "best_model.msgpack", out_dir / "metrics.csv",
                           save_dir / "last_state.msgpack")
               + ((out_dir / "loss.jpg", out_dir / "acc.jpg") if plots else ())
               if not f.is_file()]
    if missing or not test_files:
        raise AssertionError(f"the CLI did not write {missing or 'the test set'}")
    if len(res2["train_losses"]) != 1 or len(res1["train_losses"]) != CLI_EPOCHS:
        raise AssertionError(f"the runs trained {len(res1['train_losses'])} and "
                             f"{len(res2['train_losses'])} epochs, not {CLI_EPOCHS} and 1")
    if [r.split(",")[0] for r in rows] != ["epoch", "1", "2", "3"]:
        raise AssertionError(f"metrics.csv holds {rows}")
    crop = seeded_slide(device)[:CLI_CROP, :CLI_CROP].contiguous()
    final = res2["model"].eval()
    step_vs_plain = vit_step_vs_plain(final, sampler, device, label="ViT-S/16 (CLI-trained)")
    best = out_dir / "best_model.msgpack"
    for spy, first in ((spy1, 0), (spy2, CLI_EPOCHS)):
        spy.saves = [(p, first + e, sd) for p, e, sd in spy.saves]
    ref, best_epoch = saved_in_memory(cfg, spy1.saves + spy2.saves, best, device)
    loaded, read_s = checkpoint_model(cfg, best, device)
    if not same_maps(served_maps(loaded, crop, fcn=False), served_maps(ref, crop, fcn=False)):
        raise AssertionError("the ViT served from best_model.msgpack differs from the model "
                             f"saved in memory after epoch {best_epoch}")
    bare = init_model(get_model(N_CLASSES, arch="vit", depth=VIT_DEPTH), seed=SEED).to(device)
    bare_state = create_train_state(bare, cfg["training"]["lr"],
                                    weight_decay=cfg["training"]["weight_decay"])
    bare_epoch = make_fused_epoch(bare, sampler, bs, CLI_STEPS)
    gen = torch.Generator().manual_seed(SEED)
    bare_epoch(bare_state, gen)
    bare_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare_epoch(bare_state, gen)
        bare_s.append(time.perf_counter() - t0)
    epoch_fn, state = spy2.last_epoch
    prof = profile_device(lambda: epoch_fn(state, gen))
    host_ops = host_op_ms(lambda: epoch_fn(state, gen))
    secs = {n: spy1.seconds.get(n, []) + spy2.seconds.get(n, [])
            for n in set(spy1.seconds) | set(spy2.seconds)}
    out["train_cli_vit_s16"] = {
        "patches_per_s_by_epoch": [e["steps"] * bs / e["seconds"] for e in spy2.epochs],
        "bare_make_fused_epoch_patches_per_s": [CLI_STEPS * bs / t for t in bare_s],
        "epoch_busy_share": prof["device_busy_share"], "epoch_profile_wall_ms": prof["wall_ms"],
        "epoch_kernel_ms": prof["kernel_ms"], "epoch_groups_ms": prof["groups_ms"],
        "epoch_group_launches": prof["group_launches"], "epoch_host_ops_self_ms": host_ops,
        "host_seconds": secs, "checkpoint_read_s": read_s, "main_seconds": [s1, s2],
        "checkpoint_bytes": {"best_model": best.stat().st_size,
                             "last_state": (save_dir / "last_state.msgpack").stat().st_size},
        "served_from": f"the model in memory at its save after epoch {best_epoch} of "
                       f"{CLI_EPOCHS + 1}", "step_vs_plain_attention": step_vs_plain,
        "test_patches": len(test_files), "metrics_rows": rows[1:],
    }
    print(f"ViT-S/16 CLI: {json.dumps(out['train_cli_vit_s16'])}")
    del res1, res2, spy1, spy2, final, loaded, ref, bare, bare_state, bare_epoch, state, epoch_fn

    # 19. the ctx64 ResNet-18 (fcn-native), served by both predicts; the
    # multi-magnification ResNet-50 on 9 channels
    cfg, path = cli_config(Path(__file__).resolve().parent / "benchmarks/config_ctx64.yaml",
                           root, "ctx64", n_epochs=1)
    bs = cfg["training"]["batch_size"]
    res, spy, launches, secs = run_cli(["--config", str(path)], "ctx64 ResNet-18 CLI", bs)
    per_step = spy.per_step()
    if per_step.get("gather_multi_u8") != 1:
        raise AssertionError(f"the ctx64 epoch launched {per_step} a step")
    out["launches"]["train_ctx64_r18"] = (launches, per_step)
    best = Path(cfg["training"]["out_dir"]) / "best_model.msgpack"
    model, best_epoch = saved_in_memory(cfg, spy.saves, best, device)
    loaded, read_s = checkpoint_model(cfg, best, device)
    maps = {}
    for fcn in (True, False):
        maps[fcn] = served_maps(loaded, crop, fcn)
        if not same_maps(maps[fcn], served_maps(model, crop, fcn)):
            raise AssertionError(f"the ctx64 ResNet-18 served from best_model.msgpack by "
                                 f"{'predict_full_fcn' if fcn else 'predict_full_fused'} "
                                 f"differs from the model saved in memory after epoch {best_epoch}")
    out["train_ctx64_r18"] = {
        "patches_per_s": [e["steps"] * bs / e["seconds"] for e in spy.epochs],
        "main_seconds": secs, "host_seconds": spy.seconds, "checkpoint_read_s": read_s,
        "fcn_vs_exact_map_agreement": float((maps[True][0] == maps[False][0]).mean()),
        "served_from": f"the model in memory at its save after epoch {best_epoch} of 1",
    }
    del res, model, loaded, maps
    cfg, path = cli_config(pkg / "config_resnet50_multimag.yaml", root, "multimag", n_epochs=1)
    bs = cfg["training"]["batch_size"]
    res, spy, launches, secs = run_cli(["--config", str(path)], "multi-mag ResNet-50 CLI", bs)
    per_step = spy.per_step()
    if per_step.get("gather_multi_u8") != 3:
        raise AssertionError(f"the multi-mag epoch launched {per_step} a step, not 3 K1")
    bn = res["model"].bn1
    if not bool((bn.running_mean != 0).any()) or not bool((bn.running_var != 1).any()):
        raise AssertionError("multi-mag training left the BatchNorm statistics as they were")
    out["launches"]["train_multimag_r50"] = (launches, per_step)
    out["train_multimag_r50"] = {
        "patches_per_s": [e["steps"] * bs / e["seconds"] for e in spy.epochs],
        "main_seconds": secs, "host_seconds": spy.seconds, "launches_per_step": per_step}
    return out


# ---- the predict CLI (phase 20) -----------------------------------------

PRED_LAYER, PRED_BS = 2, 64  # the predict CLI's layer and batch
PRED_SIDE = MAIN_SIDE // PRED_LAYER  # its input: the 16384² slide's layer 2
PRED_MAP = PRED_SIDE // D  # its class map's side (downscale 16)
# the CLI's modes by their flags
PRED_MODES = {
    "dense": {"dense": True}, "random": {}, "host_loop_random": {"host_loop": True},
    "host_loop_dense": {"host_loop": True, "dense": True}, "int8_random": {"int8": True},
    "int8_dense": {"int8": True, "dense": True}, "int8_fcn": {"int8": True, "fcn": True},
}
# --host_loop dense against --dense (phase 20): the same bf16 inputs and
# batches, but the host loop stitches the last batch's padding (repeats of
# the last patch) as the reference does, which moves the cells under the last
# patch (196 of 512², 0.075 %)
HOST_LOOP_AGREE = 0.999
# the plain versions of the kernels, as ops modules name them
PLAIN_VERSIONS = (("gather", "gather_normalize_ref"), ("gather", "gather_patches_multi"),
                  ("gather", "gather_quantize_int8_ref"), ("stitch", "scatter_add_map_ref"),
                  ("conv_int8", "conv_int8_ref"), ("conv_int8", "conv_int8_block_ref"))


class PredictSpy:
    """While active, wraps the predict CLI's callees: its predict call (one
    of ``predict_full_fused``, ``predict_full_random_fused``,
    ``predict_full_fcn``, ``ImagePredictorPatched.process``) is timed after
    a synchronize and kept (``call``), or with ``profile`` timed under the
    profiler (the card only); the resize of the slide's layer 1 and the
    image writes (Pillow's ``Image.save``) are timed on the host, and the
    arrays saved kept by file name (``saved``); each random step's draws are
    recorded; every call of a kernel's plain version is counted
    (``plain``)."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.seconds: dict[str, float] = {}
        self.draws: list = []
        self.plain: dict[str, int] = {}
        self.saved: dict[str, np.ndarray] = {}
        self.prof = None

    def _predict(self, name, fn):
        def call(*a, **k):
            if self.profile:
                out = []
                self.prof = profile_device(lambda: out.append(fn(*a, **k)), cpu=False)
                self.seconds["predict"] = self.prof["wall_ms"] / 1e3
                self.predict_fn = name
                return out[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds["predict"] = time.perf_counter() - t0
            self.predict_fn, self.call = name, (fn, a, k)
            return out
        return call

    def _host(self, name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        import importlib

        from deephisto_tpu_torch.examples import predict_full_patched as cli
        from deephisto_tpu_torch.predict import full_patched
        from deephisto_tpu_torch.samplers import full
        from deephisto_tpu_torch.slide import base

        self._saved = []

        def patch(obj, name, new):
            self._saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)

        for n in ("predict_full_fused", "predict_full_random_fused", "predict_full_fcn"):
            patch(cli, n, self._predict(n, getattr(cli, n)))
        patch(full_patched.ImagePredictorPatched, "process",
              self._predict("ImagePredictorPatched.process", full_patched.ImagePredictorPatched.process))
        patch(base, "_resize_uint8", self._host("resize_s", base._resize_uint8))
        from PIL import Image

        save = self._host("image_s", Image.Image.save)

        def kept(im, fp, *a, **k):
            self.saved[Path(fp).name] = np.asarray(im)
            return save(im, fp, *a, **k)

        patch(Image.Image, "save", kept)
        draws = full._rnd_draws

        def record(*a):
            out = draws(*a)
            self.draws.append(tuple(t.clone() for t in out))
            return out

        patch(full, "_rnd_draws", record)
        for mod, name in PLAIN_VERSIONS:
            m = importlib.import_module(f"deephisto_tpu_torch.ops.{mod}")

            def counted(*a, _fn=getattr(m, name), _name=name, **k):
                self.plain[_name] = self.plain.get(_name, 0) + 1
                return _fn(*a, **k)
            patch(m, name, counted)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)


def pred_dataset(root: Path, device) -> Path:
    """A dataset whose one test slide is phase 4's seeded slide (16384²),
    written as DHS with layers 1, 2, 4 and an empty annotation file, under
    a folder without the synthetic marker."""
    from deephisto_tpu_torch.slide import write_dhs

    ds = root / "predict_ds"
    (ds / "annotations" / "test").mkdir(parents=True)
    (ds / "annotations" / "test" / "test_00.json").write_text("[]")
    write_dhs(seeded_slide(device).cpu().numpy(), ds / "images" / "test" / "test_00.dhs",
              max_layer=4)
    return ds


def replay_random(image, model, draws, steps):
    """The random predict's first ``steps`` steps on the recorded ``draws``
    through the plain K1 (for the int8 model its int8 mode, in the model's
    layout), the plain K2 (the sequential loop) and, for the int8 model,
    K6's plain version → (score map, coverage)."""
    from deephisto_tpu_torch.ops.gather import gather_normalize_ref, gather_quantize_int8_ref
    from deephisto_tpu_torch.ops.stitch import scatter_add_map_ref
    from deephisto_tpu_torch.samplers import full

    dev = image.device
    lut = getattr(model, "input_lut", None)
    if lut is not None:
        layout, pre_packed = model.input_layout(False)
        kwargs = {"pre_packed": pre_packed} if pre_packed else {}
        one_slide = torch.zeros((PRED_BS,), dtype=torch.int32, device=dev)
    score = torch.zeros((PRED_MAP, PRED_MAP, N_CLASSES), device=dev)
    accum = torch.zeros((PRED_SIDE // 16, PRED_SIDE // 16, 1), device=dev)
    it = iter(draws)
    saved, full._rnd_draws = full._rnd_draws, lambda *a: next(it)
    try:
        with torch.inference_mode(), RecordConvs(record=False, plain=True):
            for _ in range(steps):
                coords = full.rnd_coords(None, accum, PRED_SIDE, PRED_SIDE, PRED_BS, PS, 16, 2)
                if lut is None:
                    logits = model(gather_normalize_ref(image, coords, PS, torch.bfloat16))
                else:
                    logits = model(gather_quantize_int8_ref(image[None], one_slide, coords, PS, lut,
                                                            layout), **kwargs)
                scatter_add_map_ref(score, coords // D, logits, PS // D)
                scatter_add_map_ref(accum, coords // 16, torch.ones(PRED_BS, device=dev), PS // 16 + 1)
    finally:
        full._rnd_draws = saved
    return score, accum[..., 0]


def count_syncs(fn) -> int:
    """The host syncs torch sees (``torch.cuda.set_sync_debug_mode``: one
    warning each) in one call of ``fn``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def int8_cli_calls(image, qdense, qfcn) -> tuple[dict, dict]:
    """The K6 calls of one ``--int8 --dense`` batch (the first 64 dense
    windows, K1's int8 mode, through the predicts' BatchPredictor) and of
    one ``--int8 --fcn`` tile batch (the first 16 tiles of the edge-padded
    layer, as ``predict_full_fcn`` gathers them) of the CLI's quantized
    models → ({path: calls}, {path: K1's int8-mode inputs})."""
    from deephisto_tpu_torch.ops import gather_quantize_int8
    from deephisto_tpu_torch.predict import dense_coords
    from deephisto_tpu_torch.predict.fcn import _fc, _grid, tile_logits
    from deephisto_tpu_torch.predict.pipeline import BatchPredictor, edge_pad

    dev = image.device
    coords = torch.from_numpy(dense_coords(PRED_SIDE, PRED_SIDE, PS, STRIDE)[:PRED_BS])
    step = BatchPredictor(image, False, qdense, PS, D, PRED_BS, dev)
    score = torch.zeros((PRED_MAP, PRED_MAP, N_CLASSES), device=dev)
    with RecordConvs() as dense_rec, torch.inference_mode():
        step(score, coords, PRED_BS)
    ty, tx, pad_y, pad_x = _grid(PRED_SIDE, PRED_SIDE, FCN_TILE, FCN_HALO)
    bank = edge_pad(image, pad_y, pad_x)[None].contiguous()
    t = np.arange(min(FCN_TB, ty * tx))
    origin = torch.from_numpy((np.stack([t // tx, t % tx], 1) * FCN_TILE).astype(np.int32))
    sidx = torch.zeros((len(t),), dtype=torch.int32)
    layout, model_packed = qfcn.input_layout(False)
    with RecordConvs() as fcn_rec, torch.inference_mode():
        tiles = gather_quantize_int8(bank, sidx, origin, FCN_TILE + 2 * FCN_HALO, qfcn.input_lut,
                                     layout)
        tile_logits(qfcn, tiles, FCN_HALO // 32, FCN_TILE // 32, _fc(qfcn)[0],
                    pre_packed=model_packed)
    k1 = {"int8_dense_batch": (image[None], step.one_slide, coords, PS, qdense.input_lut,
                               step.layout),
          "int8_fcn_tile_batch": (bank, sidx, origin, FCN_TILE + 2 * FCN_HALO, qfcn.input_lut,
                                  layout)}
    return ({f"int8_dense_batch_{PRED_BS}x{PS}": dense_rec.calls,
             f"int8_fcn_tile_batch_{len(t)}x{FCN_TILE + 2 * FCN_HALO}": fcn_rec.calls}, k1)


def run_predict_cli(label: str, flags: dict, weights: Path, out_dir: Path) -> dict:
    """The predict CLI's body in one mode: a timed run under a PredictSpy,
    every launch count set to 0 just before and read just after, then its
    predict call again under the profiler and once more counting its host
    syncs (the host loops, whose sampler is spent after one run, are timed
    under the profiler only). Checks the three JPEGs.
    Returns the numbers, with the run's result ("result") and its spy
    ("spy")."""
    import importlib

    from PIL import Image

    from deephisto_tpu_torch import _build

    cli = importlib.import_module("deephisto_tpu_torch.examples.predict_full_patched")
    host_loop = bool(flags.get("host_loop"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PredictSpy(profile=host_loop) as spy:
        _build.reset_launches()
        t0 = time.perf_counter()
        result = cli.predict_full_patched(weights, out_dir=out_dir, **flags)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {k: v for k, v in _build.launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = None
    if host_loop:  # timed under the profiler: its sampler is spent after one run
        prof = spy.prof
    else:  # the same predict call again, under the profiler, then counting syncs
        fn, a, k = spy.call
        prof = profile_device(lambda: fn(*a, **k), cpu=False)
        syncs = count_syncs(lambda: fn(*a, **k))
    pred = result["pred"]
    if pred.shape != (PRED_MAP, PRED_MAP) or pred.dtype != np.uint8 or int(pred.max()) >= N_CLASSES:
        raise AssertionError(f"predict CLI {label}: map {pred.shape} {pred.dtype}")
    if spy.plain:
        raise AssertionError(f"predict CLI {label} ran plain versions: {spy.plain}")
    # the arrays Pillow was given, and the JPEG files it wrote of them
    saved = {k: spy.saved[p.name] for k, p in result["paths"].items()}
    if (any(p.suffix != ".jpg" or Image.open(p).format != "JPEG" for p in result["paths"].values())
            or any(a.shape != (PRED_MAP, PRED_MAP, 3) for a in saved.values())):
        raise AssertionError(f"predict CLI {label}: images {list(result['paths'].values())}, "
                             f"shapes {[a.shape for a in saved.values()]}")
    if not np.array_equal(saved["overlay"], (saved["original"] * 0.6 + saved["mask"] * 0.4)
                          .astype(np.uint8)):
        raise AssertionError(f"predict CLI {label}: the overlay does not follow its formula")
    row = {"predict_s": spy.seconds["predict"], "predict_fn": spy.predict_fn,
           "cli_s": total_s, "resize_s": spy.seconds.get("resize_s"),
           "image_s": spy.seconds.get("image_s"), "peak_gib": peak, "launches": launches,
           "host_syncs": syncs,
           "busy_share": prof["device_busy_share"], "profile_wall_ms": prof["wall_ms"],
           "kernel_ms": prof["kernel_ms"], "groups_ms": prof["groups_ms"],
           "result": result, "spy": spy}
    return row


def predict_cli_phase(root: Path, device) -> dict:
    """Phase 20 (module docstring). Returns the numbers by mode, with
    ``launches`` {mode: launches a predict}."""
    import os

    from deephisto_tpu_torch.predict import (
        dense_coords,
        fcn_equivalent_patches,
        predict_full_fused,
        process_on_device,
    )
    from deephisto_tpu_torch.ops import gather_quantize_int8, gather_quantize_int8_ref
    from deephisto_tpu_torch.ops.conv_int8 import conv_design
    from deephisto_tpu_torch.samplers import FullImageDenseSampler, SamplerExecutionMode
    from deephisto_tpu_torch.samplers.full import max_coverage_steps
    from deephisto_tpu_torch.slide import DHSlide
    from deephisto_tpu_torch.train import save_model

    t0 = time.perf_counter()
    ds = pred_dataset(root, device)
    data_s = time.perf_counter() - t0
    dhs = ds / "images" / "test" / "test_00.dhs"
    with DHSlide(dhs) as s:
        layer2 = s.load_layer(PRED_LAYER)
    image = torch.from_numpy(layer2).to(device)
    dense = torch.from_numpy(dense_coords(PRED_SIDE, PRED_SIDE, PS, STRIDE))
    model = seeded_model(device, depth=18)
    center_head(model, model.fc, image, dense[:: max(1, len(dense) // 64)][:64])
    weights = save_model(root / "predict_ckpt" / "best_model.msgpack", model)
    del model
    os.environ["DEEPHISTO_DATASET"] = str(ds)
    print(f"phase 20 data: the seeded {MAIN_SIDE}^2 slide written as DHS (layers 1, 2, 4) in "
          f"{data_s:.1f} s; the seeded ResNet-18 (5 classes) saved to {weights}")

    out: dict = {"data_s": data_s, "launches": {}}
    n_dense = len(dense)
    max_steps = max_coverage_steps(PRED_SIDE // 16, PRED_SIDE // 16, PRED_BS, PS, 16, 2)
    rows = {}
    for label, flags in PRED_MODES.items():
        row = run_predict_cli(label, flags, weights, root / "predict_out" / label)
        res, spy = row.pop("result"), row.pop("spy")
        want = {"gather_normalize": 1, "scatter_add_map": 1}
        if label.startswith("host_loop"):
            want = {"gather_multi_u8": 1, "scatter_add_map": 1}
        elif label.startswith("int8"):
            want = {"gather_quantize_int8": 1, "conv_int8": 1}
            if label != "int8_fcn":
                want["scatter_add_map"] = 1
        missing = [k for k in want if row["launches"].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"predict CLI {label} never launched {missing}: {row['launches']}")
        if "steps" in res:
            row.update(steps=res["steps"], filled=res["filled"], draws=len(spy.draws),
                       max_steps=max_steps, min_coverage=float(res["coverage"].min()))
            if (res["filled"] != 1.0 or res["steps"] > max_steps or res["coverage"].min() < 1
                    or len(spy.draws) != res["steps"]):
                raise AssertionError(f"predict CLI {label}: filled {res['filled']} after "
                                     f"{res['steps']} steps (max {max_steps}, {len(spy.draws)} "
                                     f"drawn), coverage min {res['coverage'].min()}")
            n = res["steps"] * PRED_BS
        elif label == "int8_fcn":
            n = fcn_equivalent_patches(PRED_SIDE, PRED_SIDE)
        elif label == "host_loop_random":  # the sampler's steps, one draw each
            row.update(steps=len(spy.draws), max_steps=max_steps)
            n = len(spy.draws) * PRED_BS
        else:
            n = n_dense
        row["patches_per_s"] = n / row["predict_s"]
        rows[label] = row
        res["draws"] = spy.draws
        rows[label]["_res"] = res
        out["launches"][f"predict_cli_{label}"] = row["launches"]
        print(f"predict CLI {label}: {n} patches in {row['predict_s']:.4f} s = "
              f"{row['patches_per_s']:.1f} patches/s ({row['predict_fn']}"
              + ("; under the profiler" if label.startswith("host_loop") else "") + "); busy "
              f"{row['busy_share']:.3f}; peak {row['peak_gib']:.2f} GiB; resize of layer 1 "
              f"{row['resize_s']:.3f} s, JPEGs {row['image_s']:.3f} s; CLI {row['cli_s']:.2f} s; "
              f"launches {row['launches']}; host syncs a predict {row['host_syncs']}"
              + (f"; steps {row['steps']} ({row['draws']} drawn)" if "draws" in row else "")
              + (f"; sampler steps {row['steps']}" if label == "host_loop_random" else ""))

    # --dense: bit-equal to predict_full_fused with the CLI's arguments
    res = rows["dense"]["_res"]
    want_map, want_score = predict_full_fused(layer2, res["model"], N_CLASSES, patch_size=PS,
                                              stride=STRIDE, batch_size=PRED_BS, downscale=D)
    if not (np.array_equal(res["pred"], want_map) and torch.equal(res["scores"], want_score)):
        raise AssertionError("predict CLI --dense differs from predict_full_fused")
    # random and --int8 random: bit-equal to a replay of their own draws
    # through the plain K1 and K2 (and K6's plain version for the int8 model)
    for label in ("random", "int8_random"):
        res = rows[label]["_res"]
        score, cov = replay_random(image, res["model"], res["draws"], res["steps"])
        if not (torch.equal(score, res["scores"])
                and np.array_equal(cov.cpu().numpy(), res["coverage"])):
            raise AssertionError(f"the {label} predict differs from its replay through the "
                                 "plain versions")
        del score, cov
    print("random and --int8 random predicts: maps, scores and coverage bit-equal to the replay "
          "of their draws through the plain K1, K2 (and K6)")
    # --host_loop dense against --dense: f32 patches against bf16 ones; off
    # the cells under the last patch (HOST_LOOP_AGREE) the maps must be equal
    host, dense_map = rows["host_loop_dense"]["_res"]["pred"], rows["dense"]["_res"]["pred"]
    corner = (PRED_SIDE - PS) // D
    off = np.ones_like(host, dtype=bool)
    off[corner:, corner:] = False
    agree = {"host_loop_dense_vs_dense": float((host == dense_map).mean()),
             "host_loop_dense_vs_dense_off_the_last_patch": float((host == dense_map)[off].mean())}
    # --int8 --dense: bit-equal to predict_full_fused on the same quantized model
    res = rows["int8_dense"]["_res"]
    want_map, want_score = predict_full_fused(layer2, res["model"], N_CLASSES, patch_size=PS,
                                              stride=STRIDE, batch_size=PRED_BS, downscale=D)
    if not (np.array_equal(res["pred"], want_map) and torch.equal(res["scores"], want_score)):
        raise AssertionError("predict CLI --int8 --dense differs from predict_full_fused")
    agree["int8_fcn_vs_int8_dense"] = float((rows["int8_fcn"]["_res"]["pred"] == res["pred"]).mean())
    agree["int8_dense_vs_dense"] = float((res["pred"] == rows["dense"]["_res"]["pred"]).mean())

    # the dense sampler in ONDISK mode (host slices of the memory-mapped layer)
    # through process_on_device
    model = rows["dense"]["_res"]["model"]
    sampler = FullImageDenseSampler(dhs, layer=PRED_LAYER, patch_size=PS, batch_size=PRED_BS,
                                    stride=STRIDE, mode=SamplerExecutionMode.ONDISK_MULTIPROC)
    from deephisto_tpu_torch import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    with PredictSpy() as spy:
        t0 = time.perf_counter()
        ondisk = process_on_device(sampler, model, N_CLASSES, downscale=D, verbose=False)
        torch.cuda.synchronize()
        ondisk_s = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches.items() if v}
    if spy.plain or launches.get("scatter_add_map", 0) == 0:
        raise AssertionError(f"ONDISK process_on_device: plain {spy.plain}, launches {launches}")
    agree["ondisk_process_on_device_vs_host_loop_dense"] = float(
        (ondisk == rows["host_loop_dense"]["_res"]["pred"]).mean())
    rows["ondisk_process_on_device"] = {"predict_s": ondisk_s, "patches_per_s": n_dense / ondisk_s,
                                        "launches": launches}
    out["launches"]["predict_ondisk_process_on_device"] = launches
    print(f"ONDISK dense sampler through process_on_device: {n_dense} patches in {ondisk_s:.3f} s "
          f"= {n_dense / ondisk_s:.1f} patches/s; launches {launches}; agreement {json.dumps(agree)}")
    if agree["host_loop_dense_vs_dense"] < HOST_LOOP_AGREE:
        raise AssertionError(f"--host_loop dense agrees with --dense on {agree} of cells")
    if agree["ondisk_process_on_device_vs_host_loop_dense"] < 0.999:
        raise AssertionError(f"ONDISK process_on_device agrees with the host loop on {agree}")

    # K6 on every conv of one --int8 --dense batch and one --int8 --fcn tile
    # batch of the CLI's quantized models, and K1's int8 mode on their inputs
    calls, k1_args = int8_cli_calls(image, rows["int8_dense"]["_res"]["model"],
                                    rows["int8_fcn"]["_res"]["model"])
    for path, args in k1_args.items():
        got = gather_quantize_int8(*args)
        if not (torch.equal(got, gather_quantize_int8(*args))
                and torch.equal(got, gather_quantize_int8_ref(*args))):
            raise AssertionError(f"K1's int8 mode differs from its plain version on {path}")
        print(f"K1 gather_quantize_int8 [{path}, {args[5]}]: bit-equal to the plain version at "
              f"{tuple(got.shape)}, two runs identical")
    del got
    for path, path_calls in calls.items():
        designs: dict = {}
        for mode, args in path_calls:
            check_k6_call(mode, args)
            design = conv_design(args[0].shape[3])
            designs[design] = designs.get(design, 0) + 1
        stem = path_calls[0][1]
        print(f"K6 conv_int8 [{path}]: the {len(path_calls)} convs bit-equal to the plain version "
              f"in their own modes and in f32 and int8, two runs identical (designs {designs}; "
              f"stem x {tuple(stem[0].shape)} w {tuple(stem[1].shape)} stride {stem[2]})")
    del calls, k1_args
    for row in rows.values():
        row.pop("_res", None)
    out.update(modes=rows, agreement=agree)
    return out



# ---- the serving daemon (phase 21) ----------------------------------------

STREAM_ROWS = 2048  # the streamed predicts' stripe rows
PATCH_CLIENTS, PATCH_REQUESTS = 64, 4  # concurrent /v1/patch clients, requests each
PATCH_TOL = 1e-5  # a coalesced patch answer vs the direct 8-lane forward (softmax probs)
# the folded-stem vit2p8 "to bf16 rounding": against the float32 model on
# the 2048² crop, its map agrees at most 1 point less than the unfolded bf16
# model's, and its largest score gap is at most twice that model's
FOLD_AGREE_SLACK, FOLD_GAP_RATIO = 0.01, 2.0
VIT_CALIB_N = 32  # calibration patches of the int8 ViTs, gathered from the slide
# the plain versions the daemon's path must not call: the kernels' (phase
# 20's list), the int8 Dense's, K3's and the ViT's plain attention
DAEMON_PLAIN = tuple((f"deephisto_tpu_torch.ops.{m}", n) for m, n in PLAIN_VERSIONS) + (
    ("deephisto_tpu_torch.models.quantize_vit", "int8_matmul_ref"),
    ("deephisto_tpu_torch.ops.attention", "flash_attention_ref"),
    ("deephisto_tpu_torch.models.vit", "attention_plain"),
)


class CountPlain:
    """While active, counts every call of a plain version in ``DAEMON_PLAIN``
    (``counts``), passing it through."""

    def __enter__(self):
        self.counts, self._saved = {}, []
        for mod, name in DAEMON_PLAIN:
            m = importlib.import_module(mod)
            fn = getattr(m, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **k)
            self._saved.append((m, name, fn))
            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for m, name, fn in reversed(self._saved):
            setattr(m, name, fn)


class RecordViT:
    """Within ``with``: the int8 ViT's K6 calls (f32 and block modes) and its
    int8 Dense products are recorded with their inputs, and run as usual."""

    def __enter__(self):
        qv = importlib.import_module("deephisto_tpu_torch.models.quantize_vit")

        self._saved = qv.conv_f32, qv.conv_int8_block, qv.int8_matmul
        self.convs, self.dense = [], []
        f32, block, mm = self._saved

        def conv_f32(*args):
            self.convs.append(("f32", args))
            return f32(*args)

        def conv_block(*args):
            self.convs.append(("block", args))
            return block(*args)

        def int8_matmul(x8, w8):
            self.dense.append((x8, w8))
            return mm(x8, w8)

        qv.conv_f32, qv.conv_int8_block, qv.int8_matmul = conv_f32, conv_block, int8_matmul
        return self

    def __exit__(self, *exc):
        qv = importlib.import_module("deephisto_tpu_torch.models.quantize_vit")
        qv.conv_f32, qv.conv_int8_block, qv.int8_matmul = self._saved


def http(url, body=None, content_type="application/x-npy", method=None):
    """One request: (status, headers, body bytes)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method or ("POST" if body is not None
                                                                     else "GET"))
    if body is not None:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def npy_bytes(arr) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def npy_load(body: bytes):
    import io

    return np.load(io.BytesIO(body))


def check_vit_k6(calls, label: str) -> list:
    """K6 against its plain version on every recorded conv of one int8 ViT
    batch (``check_k6_call``: its own mode and the f32 and int8 modes,
    bit-equal, two runs identical), each timed in its own mode beside its
    bound and its plain version, with its design."""
    from deephisto_tpu_torch.ops import conv_int8 as k6

    rows = []
    for mode, args in calls:
        x, w, stride, pads = args[:4]
        outs = check_k6_call(mode, args)
        oh, ow = outs["f32"].shape[1:3]
        nbytes, ops = conv_bytes_ops(x, w, mode, args[6:], oh, ow)
        ms = cuda_ms(lambda i: _run_k6(mode, args), 10)
        plain_ms = cuda_ms(lambda i: _plain_k6(mode, args), 2, warmup=1)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OP_PER_S * 1e3
        rows.append(dict(model=label, x=list(x.shape), w=list(w.shape), stride=stride,
                         pads=[list(p) for p in pads], mode=mode,
                         design=k6.conv_design(x.shape[3]), ms=ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms > ops_ms else "operations"))
        print(f"K6 conv_int8 [{label}] {rows[-1]['design']} x {tuple(x.shape)} w "
              f"{tuple(w.shape)} stride {stride} pads {pads} {mode}: bit-equal to the plain "
              f"version in {', '.join(outs)}; {ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms, "
              f"plain {plain_ms:.3f} ms")
        del outs
    return rows


def check_int_mm(dense, label: str) -> dict:
    """Each recorded int8 Dense product (``torch._int_mm``) against its plain
    version (the float64 product of the integer values), bit-equal; each
    distinct shape timed beside its bound."""
    from deephisto_tpu_torch.models.quantize_vit import int8_matmul, int8_matmul_ref

    shapes = {}
    for x8, w8 in dense:
        got = int8_matmul(x8, w8)
        if got.dtype != torch.int32 or not torch.equal(got, int8_matmul_ref(x8, w8)):
            raise AssertionError(f"_int_mm differs from the float64 product at "
                                 f"{tuple(x8.shape)} x {tuple(w8.shape)} ({label})")
        key = (tuple(x8.shape), tuple(w8.shape))
        if key not in shapes:
            (m, k), n = x8.shape, w8.shape[0]
            nbytes, ops = m * k + n * k + 4 * m * n, 2.0 * m * n * k
            shapes[key] = dict(
                ms=cuda_ms(lambda i: int8_matmul(x8, w8), 10),
                plain_ms=cuda_ms(lambda i: int8_matmul_ref(x8, w8), 2, warmup=1),
                bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / INT8_OP_PER_S) * 1e3, calls=0)
        shapes[key]["calls"] += 1
    out = {f"{list(a)}x{list(b)}": v for (a, b), v in shapes.items()}
    print(f"int8 Dense [{label}]: {len(dense)} _int_mm products bit-equal to the float64 "
          f"product; by shape {json.dumps(out)}")
    return out


def time_b7(device) -> dict:
    """B7 (``gumbel_topk``, ``coverage_cell_topk``: torch ops) timed apart at
    the random predicts' shapes (phase 21's daemon: a (1024, 1024) coverage
    grid, 512 cells a step; phase 20's CLI: (512, 512), 64), on given noise,
    beside its byte bound: its inputs read once (the accumulator or the
    log-weights and the noise, f32) and the k int64 indices written once."""
    from deephisto_tpu_torch.ops import coverage_cell_topk, gumbel_topk

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    out = {}
    for side, k in ((MAIN_SIDE // 16, 512), (PRED_SIDE // 16, PRED_BS)):
        n = side * side
        accum = torch.randint(0, 4, (side, side, 1), generator=gen, device=device).float()
        noise = torch.rand(n, generator=gen, device=device)
        logw = torch.where(accum.reshape(-1) >= 2, -1e9, 0.0)
        bound_ms = (8 * n + 16 * k) / HBM_BYTES_PER_S * 1e3
        row = {
            "coverage_cell_topk_ms": cuda_ms(lambda i: coverage_cell_topk(noise, accum, 2, k), 20),
            "gumbel_topk_ms": cuda_ms(lambda i: gumbel_topk(noise, logw, k), 20),
            "coverage_cell_topk_bound_ms": bound_ms,
            "gumbel_topk_bound_ms": (8 * n + 8 * k) / HBM_BYTES_PER_S * 1e3,
        }
        out[f"{side}x{side}_k{k}"] = row
    print("B7 (torch ops) at the random predicts' shapes: " + json.dumps(out))
    return out


def daemon_phase(root: Path, device) -> dict:
    """Phase 21, the serving daemon at full width on the card: a float and
    an int8 ``ServingEngine`` over a ``save_model`` checkpoint of the seeded
    s2d ResNet-18 behind ``serve_in_thread``; the 16384² slide over
    ``/v1/slide`` in each mode and staged, bit-equal to the direct calls;
    ``/v1/patch`` at 1 and 64 clients; both streamed predicts bit-equal to
    the resident ones; the folded-stem and int8 ViTs. Returns the report,
    with the launches of each path under ``"launches"``."""
    import concurrent.futures

    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.models import fold_vit_stem, quantize_vit
    from deephisto_tpu_torch.ops import gather_normalize, gather_quantize_int8
    from deephisto_tpu_torch.predict import (
        dense_coords,
        fcn_equivalent_patches,
        predict_full_fcn,
        predict_full_fcn_streamed,
        predict_full_fused,
        predict_full_random_fused,
        predict_full_streamed,
    )
    from deephisto_tpu_torch.serve import ServingEngine, serve_in_thread
    from deephisto_tpu_torch.serve.engine import MODES
    from deephisto_tpu_torch.train.checkpoint import save_model

    report, launches, plain = {}, {}, {}
    slide = seeded_slide(device)
    slide_np = slide.cpu().numpy()
    dense = torch.from_numpy(dense_coords(MAIN_SIDE, MAIN_SIDE, PS, STRIDE))
    n_patches, n_equiv = len(dense), fcn_equivalent_patches(MAIN_SIDE, MAIN_SIDE)
    r18 = seeded_model(device, depth=18, stem="s2d")
    center_head(r18, r18.fc, slide, dense[:: n_patches // 64][:64])
    ckpt = save_model(root / "serve" / "best_model.msgpack", r18)
    cfg_path = root / "serve" / "config.yaml"
    write_yaml(cfg_path, {"model": {"n_classes": N_CLASSES, "depth": 18, "stem": "s2d"},
                          "dataset": {"patch_size": PS}})
    del r18
    engines = {"bf16": ServingEngine.from_checkpoint(cfg_path, ckpt),
               "int8": ServingEngine.from_checkpoint(cfg_path, ckpt, int8=True)}
    body = npy_bytes(slide_np)
    random_batch = min(512, (MAIN_SIDE // 16) ** 2)

    def direct(eng, mode):
        """The engine's predict of ``mode`` as a direct call, timed."""
        model = eng._model_for(mode)
        fcn = dict(patch_size=PS, tile=eng.tile, halo=eng.halo, tile_batch=eng.tile_batch)
        call = {"fcn": lambda: predict_full_fcn(slide_np, model, N_CLASSES, **fcn)[0],
                "dense": lambda: predict_full_fused(slide_np, model, N_CLASSES, patch_size=PS)[0],
                "random": lambda: predict_full_random_fused(
                    slide_np, model, N_CLASSES, patch_size=PS, batch_size=random_batch,
                    seed=0)[0]}[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amap = call()
        torch.cuda.synchronize()
        return amap, time.perf_counter() - t0

    # /v1/slide in each mode, then staged; /v1/patch (the daemon's path:
    # launches counted over the requests, no plain version called)
    servers = {k: serve_in_thread(e) for k, e in engines.items()}
    try:
        for kind, eng in engines.items():
            base = servers[kind][1]
            st, _, health = http(base + "/healthz")
            if st != 200 or json.loads(health)["device_name"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"/healthz of the {kind} daemon: {st} {health[:200]}")
            rows = {}
            for mode in MODES:
                direct(eng, mode)  # warm-up: cuDNN's picks, the allocator
                _build.reset_launches()
                with CountPlain() as cp:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, headers, out = http(base + f"/v1/slide?mode={mode}", body)
                    http_s = time.perf_counter() - t0
                run_launches = dict(_build.launches)
                if st != 200:
                    raise AssertionError(f"/v1/slide {mode} ({kind}): {st} {out[:300]}")
                amap = npy_load(out)
                want, direct_s = direct(eng, mode)
                if not np.array_equal(amap, want):
                    raise AssertionError(f"/v1/slide {mode} ({kind}) differs from the direct call")
                meta = json.loads(headers["X-DeepHisto-Meta"])
                n = n_equiv if mode == "fcn" else n_patches
                rows[mode] = {"http_s": http_s, "direct_s": direct_s,
                              "http_overhead_s": http_s - direct_s,
                              "patches_per_s_http": n / http_s if mode != "random" else None,
                              "patches_per_s_direct": n / direct_s if mode != "random" else None,
                              "meta": meta, "launches": run_launches}
                launches[f"daemon_{kind}_{mode}_16384"] = run_launches
                plain.update({f"{kind}_{mode}_{k}": v for k, v in cp.counts.items()})
            # stage, then the same fcn request by key
            _build.reset_launches()
            with CountPlain() as cp:
                t0 = time.perf_counter()
                st, _, out = http(base + "/v1/stage?key=slide", body)
                stage_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                st2, _, out2 = http(base + "/v1/slide?key=slide", b"")
                staged_s = time.perf_counter() - t0
            launches[f"daemon_{kind}_staged_fcn_16384"] = dict(_build.launches)
            plain.update({f"{kind}_staged_{k}": v for k, v in cp.counts.items()})
            if st != 200 or st2 != 200:
                raise AssertionError(f"staging ({kind}): {st} {out[:200]} / {st2} {out2[:200]}")
            if not np.array_equal(npy_load(out2), direct(eng, "fcn")[0]):
                raise AssertionError(f"the staged fcn map ({kind}) differs from the unstaged one")
            rows["staged_fcn"] = {"stage_http_s": stage_s, "predict_by_key_http_s": staged_s,
                                  "pack": eng._staged["slide"].pack,
                                  "pre_tiled": eng._staged["slide"].tiles is not None}
            http(base + "/v1/stage/slide", method="DELETE")
            print(f"daemon ({kind}) over HTTP on the {MAIN_SIDE}^2 slide: " + json.dumps(
                {m: {k: v for k, v in r.items() if k != "launches"} for m, r in rows.items()}))
            report[f"slide_{kind}"] = rows

        # /v1/patch: 1 client, then PATCH_CLIENTS at once, each answer held
        # against the direct 8-lane forward of its image
        eng, base = engines["bf16"], servers["bf16"][1]
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        patches = torch.randint(0, 256, (PATCH_CLIENTS, PS, PS, 3), dtype=torch.uint8,
                                generator=gen, device=device).cpu().numpy()
        bodies = [npy_bytes(p) for p in patches]
        http(base + "/v1/patch", bodies[0])  # builds the patch forward and its batcher
        with torch.inference_mode():
            lanes = eng.patch_lanes
            want = [eng._patch_fn(torch.from_numpy(patches[i:i + lanes]).to(device)).cpu().numpy()
                    for i in range(0, PATCH_CLIENTS, lanes)]
        want = np.concatenate(want)

        def ask(i):
            st, _, out = http(base + "/v1/patch", bodies[i % PATCH_CLIENTS])
            if st != 200:
                raise AssertionError(f"/v1/patch: {st} {out[:200]}")
            return i % PATCH_CLIENTS, json.loads(out)

        _build.reset_launches()
        with CountPlain() as cp:
            t0 = time.perf_counter()
            one = [ask(i) for i in range(PATCH_CLIENTS)]
            one_s = time.perf_counter() - t0
            n_req = PATCH_CLIENTS * PATCH_REQUESTS
            with concurrent.futures.ThreadPoolExecutor(PATCH_CLIENTS) as pool:
                t0 = time.perf_counter()
                many = list(pool.map(ask, range(n_req)))
                many_s = time.perf_counter() - t0
        launches["daemon_patch"] = dict(_build.launches)
        plain.update({f"patch_{k}": v for k, v in cp.counts.items()})
        gaps, exact = [], 0
        for i, ans in one + many:
            gap = float(np.abs(np.asarray(ans["probs"], np.float32) - want[i]).max())
            gaps.append(gap)
            exact += ans["probs"] == [float(p) for p in want[i]]
            if ans["class"] != int(want[i].argmax()) or gap > PATCH_TOL:
                raise AssertionError(f"/v1/patch answer {i} differs from the direct forward "
                                     f"(class {ans['class']}, largest prob gap {gap})")
        report["patch"] = {"requests_per_s_1_client": PATCH_CLIENTS / one_s,
                           f"requests_per_s_{PATCH_CLIENTS}_clients": n_req / many_s,
                           "largest_prob_gap": max(gaps), "bit_equal_answers": exact,
                           "answers": len(gaps), "launches": launches["daemon_patch"]}
        print(f"/v1/patch: {report['patch']}")
    finally:
        for srv, _ in servers.values():
            srv.shutdown()
            srv.server_close()
        for e in engines.values():
            e.close()
    del body

    # the streamed predicts at 16384^2 vs the resident ones, bit for bit
    streams = {}
    for label, fn_s, fn_r, n in (
        ("dense_bf16", lambda **k: predict_full_streamed(slide_np, engines["bf16"].model,
                                                         N_CLASSES, stripe_rows=STREAM_ROWS, **k),
         lambda: predict_full_fused(slide_np, engines["bf16"].model, N_CLASSES), n_patches),
        ("dense_int8", lambda **k: predict_full_streamed(slide_np, engines["int8"].qmodel,
                                                         N_CLASSES, stripe_rows=STREAM_ROWS, **k),
         lambda: predict_full_fused(slide_np, engines["int8"].qmodel, N_CLASSES), n_patches),
        ("fcn_int8_pack8", lambda **k: predict_full_fcn_streamed(
            slide_np, engines["int8"].qmodel_fcn, N_CLASSES, stripe_rows=STREAM_ROWS, halo=32,
            **k),
         lambda: predict_full_fcn(slide_np, engines["int8"].qmodel_fcn, N_CLASSES, halo=32),
         n_equiv),
        ("fcn_bf16", lambda **k: predict_full_fcn_streamed(
            slide_np, engines["bf16"].model, N_CLASSES, stripe_rows=STREAM_ROWS, halo=32, **k),
         lambda: predict_full_fcn(slide_np, engines["bf16"].model, N_CLASSES, halo=32), n_equiv),
    ):
        times = {"resident": [], "streamed": []}

        def timed(which):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn_r() if which == "resident" else fn_s()
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            return out

        want = timed("resident")  # in turns: resident, streamed, streamed, resident
        _build.reset_launches()
        with CountPlain() as cp:
            got = timed("streamed")
        launches[f"streamed_{label}_16384"] = dict(_build.launches)
        plain.update({f"streamed_{label}_{k}": v for k, v in cp.counts.items()})
        if not (np.array_equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"the streamed {label} predict differs from the resident one")
        del got, want
        timed("streamed")
        timed("resident")
        t = {}
        fn_s(prestage_all=True, timings=t)
        best_s, best_r = min(times["streamed"]), min(times["resident"])
        streams[label] = {
            "patches_per_s_streamed": n / best_s, "patches_per_s_resident": n / best_r,
            "streamed_s": times["streamed"], "resident_s": times["resident"],
            "prestaged_staging_s": t["staging_s"], "prestaged_compute_s": t["compute_s"],
            "upload_hidden_share": (t["staging_s"] + t["compute_s"] - best_s) / t["staging_s"],
        }
    # the engine routes an over-budget fcn slide to the streamed predict
    eng = engines["int8"]
    resident_map = eng.predict_slide(slide_np, mode="fcn")[0]
    eng.stream_above_bytes = slide_np.nbytes // 2
    routed, meta = eng.predict_slide(slide_np, mode="fcn")
    if not meta["streamed"]:
        raise AssertionError("the engine did not stream an over-budget slide")
    if not np.array_equal(routed, resident_map):
        raise AssertionError("the over-budget route's map differs from the resident one")
    report["streaming"] = streams
    print(f"streamed vs resident at {MAIN_SIDE}^2, stripe rows {STREAM_ROWS} (bit-equal maps "
          f"and scores; the over-budget engine route equal): " + json.dumps(streams))
    del engines, eng, slide_np

    # the ViT's serving forms on phase 7's 8192^2 crop
    vit_slide = slide[:VIT_SIDE, :VIT_SIDE].contiguous()
    del slide
    vit_dense = torch.from_numpy(dense_coords(VIT_SIDE, VIT_SIDE, PS, STRIDE))
    n_vit = len(vit_dense)
    batches = -(-n_vit // BS)
    calib_coords = vit_dense[:: n_vit // VIT_CALIB_N][:VIT_CALIB_N]
    calib = [gather_normalize(vit_slide, calib_coords, PS, torch.float32).cpu().numpy()]
    vits = {}
    for name, kw in (("vit2p8", dict(stem="conv", patch=VIT_PATCH)), ("vit_s16", {})):
        vit = seeded_model(device, arch="vit", depth=VIT_DEPTH, **kw)
        center_head(vit, vit.head, vit_slide, vit_dense[:: n_vit // 64][:64])
        t0 = time.perf_counter()
        qvit = quantize_vit(vit, calib)
        quant_s = time.perf_counter() - t0
        cb = vit_dense[:BS]
        with RecordViT() as rec, torch.inference_mode():  # one batch as the predict runs it
            qvit(gather_quantize_int8(vit_slide[None], torch.zeros((len(cb),), dtype=torch.int32),
                                      cb, PS, qvit.input_lut, "hwc"))
        k6_rows = check_vit_k6(rec.convs, name)
        int_mm = check_int_mm(rec.dense, name)
        del rec
        row = {"quantize_s": quant_s, "k6": k6_rows, "int_mm": int_mm}
        models = {"bf16": vit, "int8": qvit}
        if name == "vit2p8":
            models["folded"] = fold_vit_stem(vit)
        outs = {}
        for kind, model in models.items():
            with CountPlain() as cp:
                run_l, runs, warm_s, best_s, peak, out = run_timed(
                    lambda: predict_full_fused(vit_slide, model, N_CLASSES),
                    f"{name} {kind} predict, {VIT_SIDE}^2", VIT_SIDE, runs=1)
            outs[kind] = out
            launches[f"{name}_{kind}_8192"] = run_l
            plain.update({f"{name}_{kind}_{k}": v for k, v in cp.counts.items()})
            if run_l.get("flash_attention") != VIT_DEPTH * batches * runs:
                raise AssertionError(f"{name} {kind}: K3 launched {run_l.get('flash_attention')} "
                                     f"times over {runs} predicts, not depth x batches x runs = "
                                     f"{VIT_DEPTH * batches * runs}")
            row[kind] = {"patches_per_s": n_vit / best_s, "best_s": best_s, "warm_s": warm_s,
                         "peak_gib": peak, "launches_per_predict": {
                             k: v / runs for k, v in run_l.items() if v}}
            if kind == "int8" and name == "vit2p8":  # where the int8 ViT's time goes
                row[kind]["profile"] = profile_device(
                    lambda: predict_full_fused(vit_slide, model, N_CLASSES))
        if "folded" in outs:
            agree = float((outs["folded"][0] == outs["bf16"][0]).mean())
            gap = float((outs["folded"][1] - outs["bf16"][1]).abs().max())
            row["folded"]["agreement_with_unfolded"] = agree
            row["folded"]["largest_score_gap_to_unfolded"] = gap
            # each against the float32 model on the crop
            crop = vit_slide[:VIT_CHECK_SIDE, :VIT_CHECK_SIDE].contiguous()
            f32 = copy.deepcopy(vit)
            f32.dtype = torch.float32
            ref_map, ref_score = predict_full_fused(crop, f32, N_CLASSES)
            vs_f32 = {}
            for kind in ("bf16", "folded"):
                m, sc = predict_full_fused(crop, models[kind], N_CLASSES)
                vs_f32[kind] = {"agreement": float((m == ref_map).mean()),
                                "largest_score_gap": float((sc - ref_score).abs().max())}
            row["folded"]["vs_float32_crop"] = vs_f32
            del f32
            print(f"folded-stem vit2p8 on {VIT_SIDE}^2: argmax agreement with the unfolded bf16 "
                  f"model {agree}, largest |score gap| {gap}; against the float32 model on the "
                  f"{VIT_CHECK_SIDE}^2 crop: {json.dumps(vs_f32)} (bounds: agreement >= the "
                  f"unfolded bf16's - {FOLD_AGREE_SLACK}, gap <= {FOLD_GAP_RATIO} x its gap)")
            if (vs_f32["folded"]["agreement"] < vs_f32["bf16"]["agreement"] - FOLD_AGREE_SLACK
                    or vs_f32["folded"]["largest_score_gap"]
                    > FOLD_GAP_RATIO * vs_f32["bf16"]["largest_score_gap"]):
                raise AssertionError("the folded-stem vit2p8 is farther from the float32 model "
                                     "than bf16 rounding")
        row["int8_agreement_with_bf16"] = float((outs["int8"][0] == outs["bf16"][0]).mean())
        vits[name] = row
        print(f"{name}: " + json.dumps({k: v for k, v in row.items() if k not in ("k6",)}))
        del vit, qvit, models, outs
    report["vit"] = vits

    called = {k: v for k, v in plain.items() if v}
    if called:
        raise AssertionError(f"plain versions called on the daemon's path: {called}")
    total = {}
    for run_l in launches.values():
        for k, v in run_l.items():
            total[k] = total.get(k, 0) + v
    for name in ("gather_normalize", "gather_quantize_int8", "gather_multi_u8",
                 "scatter_add_map", "flash_attention", "conv_int8"):
        if not total.get(name):
            raise AssertionError(f"phase 21 never launched {name}: {total}")
    report["launch_totals"] = total
    report["b7"] = time_b7(device)
    report["launches"] = launches
    return report



# ---- 22. the parallel paths --------------------------------------------------

PAR_WORLD = 2  # ranks sharing the one card over gloo
PAR_TIMEOUT = 300  # seconds the spawned ranks may take together
PAR_STEP_BATCH = BS  # global batch of the parallel train steps: the training path's
PAR_MICROBATCHES = 8  # the pipeline's microbatches (8 of 32 rows at 256)
PAR_EPOCH_STEPS = 3  # steps of each data-parallel fused epoch
PAR_STEP_RTOL = 2e-4  # f32 data-parallel steps and epochs vs world 1 (tests/test_multichip.py's)
PAR_F32_LOSS_REL = 1e-5  # f32 TP and PP steps vs the single step: the loss, relative
PAR_F32_GRAD_REL = 1e-4  # and every gradient's ||g - g'|| / ||g'||
PAR_SCORE_REL = 1e-5  # world-2 predict scores vs world 1, of the largest |score|
PAR_FCN_ATOL = 1e-5  # world-2 fcn scores vs the single fcn (test_multichip.py's bound)


def par_models(device):
    """Phase 22's seeded models: the bf16 ResNet-18 of phase 4 (its head
    centred), the int8 s2d ResNet-18 of phases 11-13 (pack_l1), and the
    slide."""
    from deephisto_tpu_torch.predict import dense_coords

    slide = seeded_slide(device)
    dense = torch.from_numpy(dense_coords(MAIN_SIDE, MAIN_SIDE, PS, STRIDE))
    spread = dense[:: max(1, len(dense) // 64)][:64]
    r18 = seeded_model(device, depth=18)
    center_head(r18, r18.fc, slide, spread)
    s2d = seeded_model(device, depth=18, stem="s2d")
    _, qpack, _ = seeded_int8(device, s2d, slide, dense)
    return slide, r18, qpack


def par_train_models(device, kind: str, dtype):
    """A seeded train-mode model of phase 22's steps: phase 16's ResNet-18
    (s2d stem), vit2p8 (BN conv stem) or vit2p8 with the GroupNorm stem (the
    pipeline's)."""
    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model

    kw = {"r18": dict(depth=18, stem="s2d"),
          "vit2p8": dict(arch="vit", depth=VIT_DEPTH, stem="conv", patch=VIT_PATCH),
          "vit2p8_gn": dict(arch="vit", depth=VIT_DEPTH, stem="conv_gn", patch=VIT_PATCH)}[kind]
    return init_model(get_model(N_CLASSES, dtype=dtype, **kw), seed=SEED).to(device)


def par_batch(device, n: int = PAR_STEP_BATCH):
    """One seeded global batch, the same on every rank (a CUDA generator)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    x = torch.rand((n, PS, PS, 3), generator=gen, device=device)
    y = torch.randint(0, N_CLASSES, (n,), generator=gen, device=device)
    return x, y


def par_steps(step, state, x, y, n: int) -> list:
    out = []
    for _ in range(n):
        state, loss, _ = step(state, x, y)
        out.append(float(loss))
    return out


def par_grads(model) -> dict:
    """The gradients of the last step by canonical parameter name, on the
    host."""
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def grad_rel(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-tensor ||g - g'|| / ||g'|| over ``want``'s tensors."""
    rel = {}
    for name, ref in want.items():
        denom = float(ref.norm())
        rel[name] = float((got[name].cpu() - ref).norm()) / (denom if denom > 0 else 1.0)
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def par_dp_steps(device, mesh, dtype, kind: str, n_steps: int) -> dict:
    """``n_steps`` data-parallel steps (``make_steps(model, mesh)``) of a
    seeded model on the seeded global batch; losses and the step seconds."""
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.train import create_train_state

    model = par_train_models(device, kind, dtype)
    state = create_train_state(model, 1e-3)
    step, _ = make_steps(model, mesh)
    x, y = par_batch(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = par_steps(step, state, x, y, n_steps)
    torch.cuda.synchronize()
    return {"losses": losses, "s_per_step": (time.perf_counter() - t0) / n_steps}


def par_single_step(device, kind: str):
    """One float32 single-device step on the global batch: (loss,
    gradients by name on the host)."""
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.train import create_train_state

    model = par_train_models(device, kind, torch.float32)
    x, y = par_batch(device)
    _, loss, _ = make_steps(model)[0](create_train_state(model, 1e-3), x, y)
    return float(loss), par_grads(model)


def par_sampler(pairs):
    """Phase 14's sampler over the training slides, on this process's card."""
    from deephisto_tpu_torch.samplers import AnnoRegionRndSampler

    return AnnoRegionRndSampler(pairs, layer=TRAIN_LAYER, patch_size=PS,
                                patches_from_one_region=4, one_image_for_batch=True,
                                verbose=False)


def par_fused_epochs(device, sampler, mesh) -> dict:
    """Phase 16's recipe (ResNet-18 (s2d), lr 1e-3, batch ``BS``) in float32
    with phase 14's crop (``TRAIN_CROP``) and flips, through
    ``make_fused_epoch(mesh=)``: one epoch of ``PAR_EPOCH_STEPS`` steps on
    presampled coordinates and one that samples every step. Losses,
    correct counts and each epoch's launches."""
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.models.patch_cls_simple import make_fused_epoch
    from deephisto_tpu_torch.train import create_train_state

    out = {}
    for name, chunk in (("presampled", 8), ("per_step", 0)):
        model = par_train_models(device, "r18", torch.float32)
        state = create_train_state(model, 1e-3)
        epoch = make_fused_epoch(model, sampler, BS, PAR_EPOCH_STEPS, mesh=mesh,
                                 crop_pad=TRAIN_CROP, presample_chunk=chunk)
        torch.cuda.synchronize()
        _build.reset_launches()
        _, losses, corrects = epoch(state, torch.Generator().manual_seed(SEED + 16))
        torch.cuda.synchronize()
        out[name] = {"losses": losses.tolist(), "corrects": corrects.tolist(),
                     "launches": {k: v for k, v in _build.launches.items() if v}}
    return out


def epochs_match(got: dict, want: dict) -> list:
    """What differs between two ``par_fused_epochs`` results: losses beyond
    ``PAR_STEP_RTOL``, any correct count."""
    bad = []
    for name in want:
        g, w = got[name], want[name]
        if not np.allclose(g["losses"], w["losses"], rtol=PAR_STEP_RTOL, atol=0):
            bad.append(f"{name} epoch losses {g['losses']} vs {w['losses']}")
        if g["corrects"] != w["corrects"]:
            bad.append(f"{name} epoch correct counts {g['corrects']} vs {w['corrects']}")
    return bad


def f32_step_faults(o: dict) -> bool:
    """A float32 TP or PP step off the single step beyond the f32 bounds."""
    return (abs(o["loss"] - o["loss_single"]) > PAR_F32_LOSS_REL * abs(o["loss_single"])
            or o["grad_rel"][0] > PAR_F32_GRAD_REL)


def par_rank(rank: int, world: int, store: str, root: str) -> None:
    """One rank of phase 22's world over gloo on the shared card: the three
    predicts, the data-parallel steps and fused epochs, the tensor- and
    pipeline-parallel vit2p8 steps; its readings and launches go to
    ``root``."""
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.parallel import (
        create_pipeline_state,
        initialize,
        make_mesh,
        make_pipeline_steps,
        make_pp_mesh,
        pipeline_params_to_canonical,
        place_vit_tensor_parallel,
        predict_full_fcn_spatial,
        predict_full_spatial,
    )
    from deephisto_tpu_torch.parallel._comm import gather_dim, host_staged
    from deephisto_tpu_torch.parallel.tensor import vit_tp_spec
    from deephisto_tpu_torch.predict import predict_full_fused
    from deephisto_tpu_torch.train import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deephisto_tpu_torch._device import resolve_device

    initialize(init_method=f"file://{store}", world_size=world, rank=rank, backend="gloo")
    device = resolve_device()
    mesh = make_mesh()
    out = {"launches": {}, "seconds": {}}

    def path(name, fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: v for k, v in _build.launches.items() if v}
        torch.cuda.empty_cache()  # the other rank shares the card
        return res

    slide, r18, qpack = par_models(device)
    ref = torch.load(Path(root) / "world1.pt", weights_only=False)
    path("dp_predict_warm", lambda: predict_full_fused(slide, r18, N_CLASSES, mesh=mesh))
    am, score = path("dp_predict", lambda: predict_full_fused(slide, r18, N_CLASSES, mesh=mesh))
    out["dp_predict"] = {"agree": float((am == ref["map"]).mean()),
                         "score_rel": float((score.cpu() - ref["score"]).abs().max()
                                            / ref["score"].abs().max())}
    am = path("spatial", lambda: predict_full_spatial(slide, r18, N_CLASSES, mesh))
    out["spatial"] = {"agree": float((am == ref["map"]).mean())}
    host = slide.cpu().numpy()
    am, score = path("fcn_spatial", lambda: predict_full_fcn_spatial(
        host, qpack, N_CLASSES, mesh, tile=FCN_TILE, halo=FCN_HALO, tile_batch=FCN_TB))
    out["fcn_spatial"] = {"agree": float((am == ref["fcn_map"]).mean()),
                          "score_abs": float((score.cpu() - ref["fcn_score"]).abs().max())}
    del slide, r18, qpack, host
    torch.cuda.empty_cache()
    out["host_staged"] = host_staged(mesh.get_group("data"), torch.zeros(1, device=device))

    # data-parallel steps against world 1: f32 (TF32 off) and bf16; the
    # fused epochs (K1-multi's rows of each global batch) against the single
    for kind in ("r18", "vit2p8"):
        out[f"dp_{kind}_f32"] = path(f"dp_{kind}_f32", lambda: par_dp_steps(
            device, mesh, torch.float32, kind, 2))
        out[f"dp_{kind}_bf16"] = path(f"dp_{kind}_bf16", lambda: par_dp_steps(
            device, mesh, torch.bfloat16, kind, 1))
    epochs = path("dp_fused_epochs", lambda: par_fused_epochs(device, par_sampler(ref["pairs"]),
                                                              mesh))
    out["dp_fused_epoch_faults"] = epochs_match(epochs, ref["epochs"])
    del out["launches"]["dp_fused_epochs"]  # counted by epoch, below
    for name, e in epochs.items():
        out["launches"][f"dp_fused_epoch_{name}"] = e.pop("launches")
    out["dp_fused_epochs"] = epochs

    # vit2p8 tensor parallel (BN conv stem), then the pipeline (GroupNorm
    # stem), float32 (TF32 off): in bf16 the MLP's partial products round to
    # bf16 before their reduce, a difference of the decomposition itself
    x, y = par_batch(device)
    loss1, grads1 = ref["single"]["vit2p8"]
    model = par_train_models(device, "vit2p8", torch.float32)
    tp_mesh = make_mesh(model=world)
    state = place_vit_tensor_parallel(create_train_state(model, 1e-3), tp_mesh)
    step = make_steps(model, tp_mesh)[0]
    _, loss, _ = path("tp_vit2p8", lambda: step(state, x, y))
    grads = {n: (gather_dim(g, vit_tp_spec(n, g).index("model"), tp_mesh.get_group("model"))
                 if "model" in vit_tp_spec(n, g) else g)
             for n, g in ((n, p.grad.detach()) for n, p in model.named_parameters()
                          if p.grad is not None)}
    out["tp_vit2p8"] = {"loss": float(loss), "loss_single": loss1,
                        "grad_rel": grad_rel(grads, grads1),
                        "fc1_rows": model.block0.fc1.weight.shape[0]}
    del model, state, step, grads
    torch.cuda.empty_cache()
    loss1, grads1 = ref["single"]["vit2p8_gn"]
    pp_mesh = make_pp_mesh(stages=world)
    base = par_train_models(device, "vit2p8_gn", torch.float32)
    state = create_pipeline_state(base, pp_mesh, 1e-3)
    step = make_pipeline_steps(base, pp_mesh, n_microbatches=PAR_MICROBATCHES)[0]
    _, loss, _ = path("pp_vit2p8_gn", lambda: step(state, x, y))
    net = state.model
    k = len(net.blocks)
    first = pp_mesh.get_local_rank("stage") * k
    grads = {f"vit.{n}": g for n, g in par_grads(net.vit).items()}
    for i, b in enumerate(net.blocks):
        grads.update({f"block{first + i}.{n}": g for n, g in par_grads(b).items()})
    mine = {n: g for n, g in grads1.items() if f"vit.{n}" in grads or n in grads}
    got = {n: grads.get(f"vit.{n}", grads.get(n)) for n in mine}
    out["pp_vit2p8_gn"] = {"loss": float(loss), "loss_single": loss1,
                           "grad_rel": grad_rel(got, mine), "blocks": k,
                           "microbatch_rows": PAR_STEP_BATCH // PAR_MICROBATCHES,
                           "canonical_keys": len(pipeline_params_to_canonical(state, pp_mesh))}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save(out, Path(root) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def parallel_phase(root: Path, pairs: list, device) -> dict:
    """Phase 22: the mesh routes at world 1 over NCCL against the single
    calls (bit for bit, timed beside them), the data-parallel fused epochs
    against the single epochs, then a world of ``PAR_WORLD`` ranks over
    gloo sharing the card."""
    import torch.multiprocessing as mp

    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.parallel import (
        initialize,
        make_mesh,
        predict_full_fcn_spatial,
        predict_full_spatial,
    )
    from deephisto_tpu_torch.predict import predict_full_fcn, predict_full_fused, stage_for_fcn
    from deephisto_tpu_torch.train import create_train_state

    result = {"launches": {}}
    initialize(init_method=f"file://{root / 'nccl_store'}", world_size=1, rank=0)
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"world 1 on the card joined over {backend}, not NCCL")
    mesh = make_mesh()
    slide, r18, qpack = par_models(device)

    def timed_pair(label, single_fn, mesh_fn, same, warm=True):
        """In turns: single, mesh, mesh, single after a warm-up of each
        (``warm``); best seconds of each and the mesh route's launches."""
        if warm:
            single_fn(), mesh_fn()
        best = {"single": float("inf"), "mesh": float("inf")}
        for which in ("single", "mesh", "mesh", "single"):
            torch.cuda.synchronize()
            if which == "mesh":
                _build.reset_launches()
            t0 = time.perf_counter()
            out = (single_fn if which == "single" else mesh_fn)()
            torch.cuda.synchronize()
            best[which] = min(best[which], time.perf_counter() - t0)
            if which == "mesh":
                launched = {k: v for k, v in _build.launches.items() if v}
                got = out
            else:
                want = out
        if not same(got, want):
            raise AssertionError(f"{label}: the mesh route at world 1 is not the single call bit "
                                 "for bit")
        result["launches"][f"{label}_w1"] = launched
        prof = profile_device(mesh_fn)
        row = {"single_s": best["single"], "mesh_s": best["mesh"],
               "overhead": best["mesh"] / best["single"] - 1.0, "bit_equal": True,
               "mesh_busy_share": prof["device_busy_share"], "mesh_kernel_ms": prof["kernel_ms"],
               "mesh_groups_ms": dict(list(prof["groups_ms"].items())[:6])}
        print(f"phase 22, world 1 (NCCL): {label}: single {best['single']:.4f} s, mesh "
              f"{best['mesh']:.4f} s (overhead {100 * row['overhead']:+.1f} %), bit-equal; "
              f"launches {launched}; the mesh route's busy share "
              f"{prof['device_busy_share']:.3f} ({prof['kernel_ms']:.1f} ms of kernels)")
        return row, want

    def maps_equal(a, b):
        return np.array_equal(a[0], b[0]) and bool(torch.equal(a[1], b[1]))

    row, (ref_map, ref_score) = timed_pair(
        "dp_predict", lambda: predict_full_fused(slide, r18, N_CLASSES),
        lambda: predict_full_fused(slide, r18, N_CLASSES, mesh=mesh), maps_equal)
    result["dp_predict"] = row
    result["spatial"], _ = timed_pair(
        "spatial", lambda: predict_full_fused(slide, r18, N_CLASSES),
        lambda: (predict_full_spatial(slide, r18, N_CLASSES, mesh), None),
        lambda a, b: np.array_equal(a[0], b[0]))
    # the banded fcn packs its bands on the host from the host array; the
    # single route starts from the same array (stage_for_fcn's ingest path)
    host = slide.cpu().numpy()
    fcn_kw = dict(tile=FCN_TILE, halo=FCN_HALO, tile_batch=FCN_TB)
    row, (fcn_map, fcn_score) = timed_pair(
        "fcn_spatial_int8",
        lambda: predict_full_fcn(stage_for_fcn(host, tile=FCN_TILE, halo=FCN_HALO, pack=8),
                                 qpack, N_CLASSES, **fcn_kw),
        lambda: predict_full_fcn_spatial(host, qpack, N_CLASSES, mesh, **fcn_kw), maps_equal,
        warm=False)  # host-bound: nothing to warm after phase 13
    staged = stage_for_fcn(slide, tile=FCN_TILE, halo=FCN_HALO, pack=8, pre_tile=True)
    staged_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_full_fcn(staged, qpack, N_CLASSES, **fcn_kw)
        torch.cuda.synchronize()
        staged_s.append(time.perf_counter() - t0)
    row["single_prestaged_s"] = min(staged_s)  # phase 13's headline: staged outside the timing
    result["fcn_spatial_int8"] = row
    ref_score_cpu, fcn_score_cpu = ref_score.cpu(), fcn_score.cpu()
    del slide, r18, qpack, host, staged, ref_score, fcn_score
    torch.cuda.empty_cache()

    # data-parallel steps at world 1 against the single steps, bf16, the
    # training path's batch
    def dp_step(kind, with_mesh):
        model = par_train_models(device, kind, torch.bfloat16)
        step = make_steps(model, mesh if with_mesh else None)[0]
        x, y = par_batch(device)
        state = create_train_state(model, 1e-3)
        return lambda: float(step(state, x, y)[1])

    for kind in ("vit2p8", "r18"):
        result[f"dp_{kind}_step"], _ = timed_pair(
            f"dp_{kind}_step", dp_step(kind, False), dp_step(kind, True), lambda a, b: a == b)
        torch.cuda.empty_cache()
    # what world 2 is held to: the data-parallel trajectories and fused
    # epochs at world 1, the single f32 steps of the TP and PP models
    w1 = {}
    for kind in ("r18", "vit2p8"):
        w1[f"{kind}_f32"] = par_dp_steps(device, mesh, torch.float32, kind, 2)["losses"]
        w1[f"{kind}_bf16"] = par_dp_steps(device, mesh, torch.bfloat16, kind, 1)["losses"]
    torch.cuda.empty_cache()
    sampler = par_sampler(pairs)
    single_epochs = par_fused_epochs(device, sampler, None)
    epochs = par_fused_epochs(device, sampler, mesh)
    bad = epochs_match(epochs, single_epochs)
    if bad:
        raise AssertionError("phase 22, world 1: make_fused_epoch(mesh=) vs the single epoch: "
                             + "; ".join(bad))
    for name, e in epochs.items():
        result["launches"][f"dp_fused_epoch_{name}_w1"] = e.pop("launches")
        if not result["launches"][f"dp_fused_epoch_{name}_w1"].get("gather_multi_u8"):
            raise AssertionError(f"the {name} data-parallel epoch launched no gather_multi_u8")
        single_epochs[name].pop("launches")
    result["dp_fused_epochs_w1"] = epochs
    print(f"phase 22, world 1 (NCCL): make_fused_epoch(mesh=) of phase 16's recipe in f32 "
          f"(crop {TRAIN_CROP}, batch {BS}) vs the single epoch: {json.dumps(epochs)} vs "
          f"{json.dumps(single_epochs)}")
    single = {kind: par_single_step(device, kind) for kind in ("vit2p8", "vit2p8_gn")}
    torch.save({"map": ref_map, "score": ref_score_cpu, "fcn_map": fcn_map,
                "fcn_score": fcn_score_cpu, "pairs": pairs, "epochs": single_epochs,
                "single": single}, root / "world1.pt")
    del single
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # world 2 over gloo, the ranks sharing the card
    t0 = time.perf_counter()
    ctx = mp.start_processes(par_rank, args=(PAR_WORLD, str(root / "gloo_store"), str(root)),
                             nprocs=PAR_WORLD, join=False, start_method="spawn")
    while not ctx.join(timeout=10):
        if time.perf_counter() - t0 > PAR_TIMEOUT:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 22's {PAR_WORLD} ranks did not finish in {PAR_TIMEOUT} s")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(PAR_WORLD)]
    result["world2_s"] = time.perf_counter() - t0
    failures = []
    for r, o in enumerate(ranks):
        if o["dp_predict"]["agree"] != 1.0 or o["dp_predict"]["score_rel"] > PAR_SCORE_REL:
            failures.append(f"rank {r} DP predict {o['dp_predict']}")
        if o["spatial"]["agree"] != 1.0:
            failures.append(f"rank {r} spatial predict {o['spatial']}")
        if o["fcn_spatial"]["agree"] != 1.0 or o["fcn_spatial"]["score_abs"] > PAR_FCN_ATOL:
            failures.append(f"rank {r} fcn spatial {o['fcn_spatial']}")
        for kind in ("r18", "vit2p8"):
            got, want = o[f"dp_{kind}_f32"]["losses"], w1[f"{kind}_f32"]
            if not np.allclose(got, want, rtol=PAR_STEP_RTOL, atol=0):
                failures.append(f"rank {r} DP {kind} f32 losses {got} vs world 1 {want}")
            got, want = o[f"dp_{kind}_bf16"]["losses"], w1[f"{kind}_bf16"]
            if abs(got[0] - want[0]) > LOSS_DIFF:
                failures.append(f"rank {r} DP {kind} bf16 loss {got} vs world 1 {want}")
        failures += [f"rank {r} {f}" for f in o["dp_fused_epoch_faults"]]
        for name in ("tp_vit2p8", "pp_vit2p8_gn"):
            if f32_step_faults(o[name]):
                failures.append(f"rank {r} {name} {o[name]}")
        if not o["host_staged"]:
            failures.append(f"rank {r}: a CUDA tensor's hop over gloo was not host-staged")
        for name, launched in o["launches"].items():
            result["launches"][f"{name}_w2_rank{r}"] = launched
    flash = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    for name, kernels in (("dp_predict", ("gather_normalize", "scatter_add_map")),
                          ("spatial", ("gather_normalize", "scatter_add_map")),
                          ("fcn_spatial", ("gather_quantize_int8", "conv_int8")),
                          ("dp_vit2p8_bf16", flash),
                          ("dp_fused_epoch_presampled", ("gather_multi_u8",)),
                          ("dp_fused_epoch_per_step", ("gather_multi_u8",)),
                          ("tp_vit2p8", flash), ("pp_vit2p8_gn", flash)):
        for kernel in kernels:
            if any(o["launches"][name].get(kernel, 0) == 0 for o in ranks):
                failures.append(f"a rank's {name} at world 2 launched no {kernel}")
    result["world2"] = [{k: v for k, v in o.items() if k != "launches"} for o in ranks]
    result["world1_losses"] = w1
    print(f"phase 22, world {PAR_WORLD} (gloo, the ranks sharing the card; CUDA tensors' hops "
          f"host-staged: {[o['host_staged'] for o in ranks]}): "
          + json.dumps(result["world2"]))
    if failures:
        raise AssertionError("phase 22: " + "; ".join(failures))
    return result


# -- phase 23: the long tail ---------------------------------------------------

LT_TIMED_RUNS = 3  # the exported and the live programs, best of 3 in turns
LT_AGREE = {"resnet18_bf16": 0.999, "vit2p8_bf16": 0.99}  # phases 5 and 8's argmax limits
LT_RANK_BATCH = 32  # the one step of each 2-rank state (PP: 8 microbatches of 4)
LT_NATIVE_BOXES = 4096
LT_NATIVE_REL = 1e-9  # native vs numpy clip areas, of the box's area (PS²)
LT_EXTRACT_N = 1024  # patches of the native extraction check
LT_EXTRACT_SIDE = 8192  # its host layer: the 8192² crop


NATIVE_BUILD: dict = {}  # the native library's build in the set-up (phase 2)


def build_native() -> dict:
    """Build (or load) the native host library once per process, before any
    timed phase uses it (the host gathers of phases 14-23 dispatch to it).
    Returns ``{"s": seconds, "compiled": whether g++ ran}``; fails where it
    does not build."""
    from deephisto_tpu_torch import native

    if not NATIVE_BUILD:
        compiled = not native.library_path().exists()
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError(f"the native library did not build: {native.build_log}")
        NATIVE_BUILD.update(s=time.perf_counter() - t0, compiled=compiled)
    return NATIVE_BUILD


def export_check(label, model, dtype, u8, kernel=None, per_batch=0) -> tuple[dict, dict]:
    """``export_classifier`` of ``model`` at batch BS × PS² on the card, the
    program loaded from its bytes and held to the live model on the batch
    ``u8``: bit-equal (``label`` not in ``LT_AGREE``) or the argmax limit,
    ``kernel`` launched ``per_batch`` times a batch by both; with no
    ``kernel``, the program's graph holds no registered op of the port.
    Both timed, best of LT_TIMED_RUNS in turns. Returns (row, the loaded
    program's launches on the batch)."""
    import io

    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.export import Classifier, export_classifier, load_classifier

    live = Classifier(model, dtype).eval()
    t0 = time.perf_counter()
    data = export_classifier(model, BS, PS, dtype=dtype)
    export_s = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in torch.export.load(io.BytesIO(data)).graph.nodes
                  if "deephisto" in str(n.target)})
    t0 = time.perf_counter()
    loaded = load_classifier(data)
    load_s = time.perf_counter() - t0

    def run(fn):
        torch.cuda.synchronize()
        _build.reset_launches()
        with torch.no_grad():
            out = fn(u8)
        torch.cuda.synchronize()
        return out, {k: v for k, v in _build.launches.items() if v}

    got, got_launches = run(loaded)
    want, want_launches = run(live)
    best = {"loaded": float("inf"), "live": float("inf")}
    for which in ("loaded", "live") * LT_TIMED_RUNS:
        fn = loaded if which == "loaded" else live
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn(u8)
        torch.cuda.synchronize()
        best[which] = min(best[which], time.perf_counter() - t0)
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    diff = float((got.float() - want.float()).abs().max())
    row = {"artifact_bytes": len(data), "export_s": export_s, "load_s": load_s,
           "loaded_patches_per_s": BS / best["loaded"], "live_patches_per_s": BS / best["live"],
           "argmax_agree": agree, "max_score_diff": diff, "bit_equal": bool(torch.equal(got, want)),
           "graph_ops": ops}
    if kernel:
        row["kernel_launches"] = {"loaded": got_launches.get(kernel, 0),
                                  "live": want_launches.get(kernel, 0)}
    print(f"phase 23 export {label}: {len(data)} bytes, exported in {export_s:.2f} s, loaded in "
          f"{load_s:.2f} s; loaded {row['loaded_patches_per_s']:.1f} vs live "
          f"{row['live_patches_per_s']:.1f} patches/s (best of {LT_TIMED_RUNS}, in turns); "
          f"argmax agreement {agree}, max |score diff| {diff}, bit-equal {row['bit_equal']}; "
          f"the port's ops in the graph {ops}"
          + (f"; {kernel} launches a batch {row['kernel_launches']}" if kernel else ""))
    if label in LT_AGREE:
        if agree < LT_AGREE[label]:
            raise AssertionError(f"the exported {label} agrees with the live model on {agree}")
    elif not row["bit_equal"]:
        raise AssertionError(f"the exported {label} is not the live model bit for bit")
    if kernel is None:
        if ops:
            raise AssertionError(f"{label}: the exported graph holds the port's ops {ops}")
    elif not got_launches.get(kernel, 0) == want_launches.get(kernel, 0) == per_batch:
        raise AssertionError(f"{label}: {kernel} launched {row['kernel_launches']} a batch, not "
                             f"{per_batch} by each")
    return row, got_launches


def dcp_dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).iterdir() if p.is_file())


def ckpt_rank(rank: int, world: int, store: str, root: str) -> None:
    """One rank of phase 23's world over gloo on the shared card: a
    tensor-parallel (model=2) f32 vit2p8, a 2-stage pipeline f32 vit2p8
    (GroupNorm stem) and a data-parallel f32 vit2p8 state, each after one
    step, saved by ``dist_ckpt``; rank 0 writes the canonical tensors the
    parent holds the restores to."""
    from deephisto_tpu_torch._device import resolve_device
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.parallel import (
        create_pipeline_state,
        initialize,
        make_mesh,
        make_pipeline_steps,
        make_pp_mesh,
        pipeline_params_to_canonical,
        place_vit_tensor_parallel,
    )
    from deephisto_tpu_torch.parallel.tensor import replicated_parameters, vit_tp_state_dict
    from deephisto_tpu_torch.train import create_train_state
    from deephisto_tpu_torch.train import dist_ckpt as dc

    initialize(init_method=f"file://{store}", world_size=world, rank=rank, backend="gloo")
    device, root = resolve_device(), Path(root)
    x, y = par_batch(device, LT_RANK_BATCH)
    out = {}

    def save(name, state):
        mgr = dc.checkpoint_manager(root / name)
        dc.save_train_state(mgr, 1, state, epoch=0)
        mgr.close()

    model = par_train_models(device, "vit2p8", torch.float32)
    tp_mesh = make_mesh(model=world)
    state = place_vit_tensor_parallel(create_train_state(model, 1e-3), tp_mesh)
    make_steps(model, tp_mesh)[0](state, x, y)
    # the replicas (parameters, BatchNorm statistics, moments) bit-equal on
    # both ranks, cuDNN left in its default (non-deterministic) mode
    rep = replicated_parameters(model)
    rep += [*model.buffers(), *(v for p in rep for v in state.optimizer.state[p].values())]
    flat = torch.cat([t.detach().to(device, torch.float32).reshape(-1) for t in rep])
    both = [torch.empty_like(flat) for _ in range(world)]
    torch.distributed.all_gather(both, flat)
    if not all(torch.equal(both[0], t) for t in both[1:]):
        raise AssertionError(f"the TP replicas differ across the ranks in "
                             f"{int((both[0] != both[1]).sum())} of {flat.numel()} values")
    save("tp", state)
    out["tp"] = vit_tp_state_dict(model, tp_mesh)
    del model, state

    pp_mesh = make_pp_mesh(stages=world)
    base = par_train_models(device, "vit2p8_gn", torch.float32)
    state = create_pipeline_state(base, pp_mesh, 1e-3)
    make_pipeline_steps(base, pp_mesh, n_microbatches=PAR_MICROBATCHES)[0](state, x, y)
    save("pp", state)
    out["pp"] = pipeline_params_to_canonical(state, pp_mesh)
    del base, state

    model = par_train_models(device, "vit2p8", torch.float32)
    state = create_train_state(model, 1e-3)
    make_steps(model, make_mesh())[0](state, x, y)
    save("dp", state)
    out["dp"] = model.state_dict()
    if rank == 0:
        torch.save({k: {n: t.cpu() for n, t in v.items()} for k, v in out.items()},
                   root / "canonical.pt")
    torch.distributed.destroy_process_group()


def long_tail_phase(root: Path, pairs: list, device) -> dict:
    """Phase 23: the exported classifiers (``export.py``), the distributed
    checkpoints (``train/dist_ckpt.py``) at world 1 and at 2 ranks, the
    daemon serving a checkpoint directory, the profiler (``profiling.py``)
    and the native host library (``native``). Returns the report, with the
    launches of each path under ``"launches"``."""
    import torch.multiprocessing as mp

    from deephisto_tpu_torch import _build, native
    from deephisto_tpu_torch.anno import parse_annotations
    from deephisto_tpu_torch.geometry.polygon import _clip_area_boxes_numpy
    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model, make_steps
    from deephisto_tpu_torch.ops import gather_multi_u8
    from deephisto_tpu_torch.predict import dense_coords, predict_full_fused
    from deephisto_tpu_torch.profiling import TRACE_FILE, StageTimer, annotate, trace
    from deephisto_tpu_torch.serve import ServingEngine
    from deephisto_tpu_torch.train import create_train_state
    from deephisto_tpu_torch.train import dist_ckpt as dc
    from deephisto_tpu_torch.train.checkpoint import save_model

    report, launches = {}, {}
    root = root / "long_tail"
    root.mkdir()
    slide = seeded_slide(device)
    dense = torch.from_numpy(dense_coords(MAIN_SIDE, MAIN_SIDE, PS, STRIDE))
    spread = dense[:: len(dense) // 64][:64]
    batch = dense[:: len(dense) // BS][:BS]
    u8 = gather_multi_u8(slide[None], torch.zeros(BS, dtype=torch.int32), batch, PS)

    # exports: phase 4's ResNet-18, phase 7's vit2p8 (bf16), phase 11's int8
    # ResNet-18 (s2d), each at batch 256 on one K1-gathered batch
    t0 = time.perf_counter()
    exports = {}
    r18 = seeded_model(device, depth=18)
    center_head(r18, r18.fc, slide, spread)
    exports["resnet18_bf16"], _ = export_check("resnet18_bf16", r18, torch.bfloat16, u8)
    del r18
    vit_slide = slide[:VIT_SIDE, :VIT_SIDE].contiguous()
    vit_dense = torch.from_numpy(dense_coords(VIT_SIDE, VIT_SIDE, PS, STRIDE))
    vit = seeded_model(device, arch="vit", depth=VIT_DEPTH, stem="conv", patch=VIT_PATCH)
    center_head(vit, vit.head, vit_slide, vit_dense[:: len(vit_dense) // 64][:64])
    exports["vit2p8_bf16"], launches["export_vit2p8_batch"] = export_check(
        "vit2p8_bf16", vit, torch.bfloat16, u8, "flash_attention", VIT_DEPTH)
    r18s = seeded_model(device, depth=18, stem="s2d")
    qexact, _, _ = seeded_int8(device, r18s, slide, dense)
    exports["int8_resnet18_s2d"], launches["export_int8_resnet18_batch"] = export_check(
        "int8_resnet18_s2d", qexact, torch.float32, u8, "conv_int8", 20)
    del qexact
    report["export"] = exports
    report["export_s"] = time.perf_counter() - t0
    print(f"phase 23 exports: {report['export_s']:.1f} s")

    # the distributed checkpoint at world 1: a vit2p8 bf16 train state (the
    # phase-14 recipe, batch 256) saved async after 3 steps, 2 more steps
    # while the write runs; a fresh state restored from it takes the same
    # 2 steps bit for bit; three saves kept to the last two
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the conv stem's weight gradient
    try:
        gen = torch.Generator(device=device).manual_seed(SEED + 23)
        batches = [(torch.rand((BS, PS, PS, 3), generator=gen, device=device),
                    torch.randint(0, N_CLASSES, (BS,), generator=gen, device=device))
                   for _ in range(5)]

        def fresh(seed):
            m = init_model(get_model(N_CLASSES, arch="vit", depth=VIT_DEPTH, stem="conv",
                                     patch=VIT_PATCH), seed=seed).to(device)
            return create_train_state(m, 3e-4, weight_decay=0.05)

        def steps(state, bs):
            step = make_steps(state.model)[0]
            return [float(step(state, x, y)[1]) for x, y in bs]

        state = fresh(SEED)
        steps(state, batches[:3])
        mgr = dc.checkpoint_manager(root / "dcp_vit2p8", max_to_keep=2)
        torch.cuda.synchronize()
        t_save = time.perf_counter()
        dc.save_train_state(mgr, 3, state, epoch=1, extra={"phase": 23})
        block_s = time.perf_counter() - t_save
        _build.reset_launches()
        want_losses = steps(state, batches[3:])
        mgr.wait_until_finished()
        write_s = time.perf_counter() - t_save
        launches["dcp_train_steps_during_write"] = {k: v for k, v in _build.launches.items() if v}
        ckpt_bytes = dcp_dir_bytes(mgr.step_dir(3))
        want = {n: t.clone() for n, t in state.model.state_dict().items()}
        del state
        resumed, epoch, extra = dc.restore_train_state(mgr, fresh(SEED + 1))
        got_losses = steps(resumed, batches[3:])
        same = all(torch.equal(t, want[n]) for n, t in resumed.model.state_dict().items())
        if got_losses != want_losses or not same or (epoch, extra) != (1, {"phase": 23}):
            raise AssertionError(f"the resumed vit2p8 run is not the uninterrupted one: losses "
                                 f"{got_losses} vs {want_losses}, parameters equal {same}")
        for step in (5, 6):
            dc.save_train_state(mgr, step, resumed, epoch=2)
        mgr.close()
        kept = sorted(p.name for p in mgr.directory.iterdir())
        if mgr.all_steps() != [5, 6] or kept != ["5", "6"]:
            raise AssertionError(f"three saves with max_to_keep=2 left {kept}")
        del resumed, batches
    finally:
        torch.backends.cudnn.deterministic = deterministic
    report["dcp_world1"] = {"blocking_s": block_s, "write_s": write_s, "bytes": ckpt_bytes,
                            "losses_after_save": want_losses, "resume_bit_equal": True,
                            "kept_after_3_saves": kept, "phase_s": time.perf_counter() - t0}
    print(f"phase 23 dist_ckpt world 1: vit2p8 bf16 state {ckpt_bytes} bytes, save blocked "
          f"{block_s:.4f} s of a {write_s:.4f} s write (2 train steps ran meanwhile); resumed "
          f"run bit-equal (losses {got_losses}); 3 saves kept {kept}")

    # the daemon over a checkpoint directory against the same weights'
    # msgpack: fcn and dense maps on the 8192^2 crop, bit-equal
    t0 = time.perf_counter()
    serve_dir = root / "serve"
    center_head(r18s, r18s.fc, slide, spread)
    msgpack = save_model(serve_dir / "best_model.msgpack", r18s)
    mgr = dc.checkpoint_manager(serve_dir / "ckpt", async_save=False)
    dc.save_train_state(mgr, 1, create_train_state(r18s, 1e-3), epoch=0)
    cfg_path = serve_dir / "config.yaml"
    write_yaml(cfg_path, {"model": {"n_classes": N_CLASSES, "depth": 18, "stem": "s2d"},
                          "dataset": {"patch_size": PS}})
    del r18s
    crop_np = vit_slide.cpu().numpy()
    engines = {"dir": ServingEngine.from_checkpoint(cfg_path, serve_dir / "ckpt"),
               "msgpack": ServingEngine.from_checkpoint(cfg_path, msgpack)}
    try:
        for mode in ("fcn", "dense"):
            _build.reset_launches()
            got = engines["dir"].predict_slide(crop_np, mode=mode)[0]
            torch.cuda.synchronize()
            launches[f"dcp_serve_{mode}"] = {k: v for k, v in _build.launches.items() if v}
            if not np.array_equal(got, engines["msgpack"].predict_slide(crop_np, mode=mode)[0]):
                raise AssertionError(f"the daemon's {mode} map from the checkpoint directory "
                                     "differs from the msgpack's")
    finally:
        for e in engines.values():
            e.close()
    report["serve_from_dir"] = {"modes": ["fcn", "dense"], "bit_equal": True,
                                "launches": {m: launches[f"dcp_serve_{m}"]
                                             for m in ("fcn", "dense")},
                                "phase_s": time.perf_counter() - t0}
    print(f"phase 23 daemon from the checkpoint directory: fcn and dense {VIT_SIDE}^2 maps "
          f"bit-equal to the msgpack's; launches {report['serve_from_dir']['launches']}")

    # 2 ranks over gloo on the one card: TP, PP and DP saves
    t0 = time.perf_counter()
    ctx = mp.start_processes(ckpt_rank, args=(PAR_WORLD, str(root / "gloo_store"), str(root)),
                             nprocs=PAR_WORLD, join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > PAR_TIMEOUT:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"phase 23's {PAR_WORLD} ranks did not finish in {PAR_TIMEOUT} s")
    canon = torch.load(root / "canonical.pt", weights_only=False)
    ranks_s = time.perf_counter() - t0

    def restored(kind, name):
        state = create_train_state(par_train_models(device, kind, torch.float32), 1e-3)
        dc.restore_train_state(dc.checkpoint_manager(root / name), state)
        return state

    faults = []
    for name, kind in (("tp", "vit2p8"), ("pp", "vit2p8_gn"), ("dp", "vit2p8")):
        sd = restored(kind, name).model.state_dict()
        bad = [n for n, t in sd.items() if not torch.equal(t.cpu(), canon[name][n])]
        if bad or sd.keys() != canon[name].keys():
            faults.append(f"{name}: {len(bad)} tensors differ, e.g. {bad[:3]}")
    one = create_train_state(par_train_models(device, "vit2p8", torch.float32), 1e-3)
    make_steps(one.model)[0](one, *par_batch(device, LT_RANK_BATCH))
    mgr = dc.checkpoint_manager(root / "w1", async_save=False)
    dc.save_train_state(mgr, 1, one, epoch=0)
    dp_bytes, w1_bytes = dcp_dir_bytes(root / "dp" / "1"), dcp_dir_bytes(root / "w1" / "1")
    if abs(dp_bytes - w1_bytes) > 0.05 * w1_bytes:
        faults.append(f"the world-2 DP save holds {dp_bytes} bytes, world 1 {w1_bytes}")
    if faults:
        raise AssertionError("phase 23, 2 ranks: " + "; ".join(faults))
    report["dcp_2_ranks"] = {"tp_replicas_across_ranks": "bit-equal",
                             "tp_to_world1": "bit-equal", "pp_to_single": "bit-equal",
                             "dp_bytes": dp_bytes, "world1_bytes": w1_bytes,
                             "ranks_s": ranks_s, "phase_s": time.perf_counter() - t0}
    print(f"phase 23 dist_ckpt 2 ranks (gloo, one card): the TP replicas bit-equal on both "
          f"ranks after the step (cuDNN default); TP and PP saves restored at world 1 "
          f"bit-equal to their canonical gathers, the DP save restored bit-equal; DP save "
          f"{dp_bytes} bytes vs world 1 {w1_bytes}; ranks {ranks_s:.1f} s")
    del one

    # the profiler around one vit2p8 predict of the 2048^2 crop
    t0 = time.perf_counter()
    crop = slide[:VIT_CHECK_SIDE, :VIT_CHECK_SIDE].contiguous()
    predict_full_fused(crop, vit, N_CLASSES)  # warm-up
    with trace(str(root / "trace")):
        with annotate("predict"):
            predict_full_fused(crop, vit, N_CLASSES)
    names = {e.get("name", "") for e in
             json.loads((root / "trace" / TRACE_FILE).read_text())["traceEvents"]}
    k3_names = sorted(n for n in names if "flash_fwd" in n)
    if "predict" not in names or not k3_names:
        raise AssertionError(f"the trace names the region: {'predict' in names}, K3's kernel: "
                             f"{k3_names}")
    timer, held = StageTimer(), []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timer.stage("predict", items=int(len(dense_coords(VIT_CHECK_SIDE, VIT_CHECK_SIDE, PS,
                                                           STRIDE))), sync=held):
        start.record()
        held.append(predict_full_fused(crop, vit, N_CLASSES)[1])
        end.record()
    end.synchronize()
    event_s = start.elapsed_time(end) / 1000
    if timer.totals["predict"] < event_s:
        raise AssertionError(f"StageTimer's {timer.totals['predict']} s < the events' {event_s} s")
    report["profiler"] = {"trace_bytes": (root / "trace" / TRACE_FILE).stat().st_size,
                          "k3_kernel": k3_names[0][:80], "stage_timer_s": timer.totals["predict"],
                          "cuda_event_s": event_s, "phase_s": time.perf_counter() - t0}
    print(f"phase 23 profiler: the trace names 'predict' and {k3_names[0][:60]!r}; StageTimer "
          f"{timer.totals['predict']:.4f} s >= CUDA events {event_s:.4f} s; {timer.report()}")
    del vit, crop, vit_slide

    # the native host library, built on this machine in the set-up
    built = build_native()
    regions, _ = parse_annotations(pairs, layer=TRAIN_LAYER, verbose=False)
    polys = [r.vertices_layer for rs in regions.values() for r in rs]
    rng = np.random.default_rng(SEED + 23)
    hi = max(float(p.max()) for p in polys)
    xy = rng.uniform(-PS, hi, (LT_NATIVE_BOXES, 2))
    boxes = np.concatenate([xy, xy + PS], axis=1)
    clip = {"native": 0.0, "numpy": 0.0}
    worst = 0.0
    for p in polys:
        t1 = time.perf_counter()
        a = native.clip_area_boxes_native(p, boxes)
        t2 = time.perf_counter()
        b = _clip_area_boxes_numpy(p, boxes)
        clip["native"] += t2 - t1
        clip["numpy"] += time.perf_counter() - t2
        worst = max(worst, float(np.abs(a - b).max()))
    if worst > LT_NATIVE_REL * PS * PS:
        raise AssertionError(f"native clip areas differ from numpy's by {worst}")
    host = crop_np
    coords = rng.integers(-16, LT_EXTRACT_SIDE - PS + 16, (LT_EXTRACT_N, 2)).astype(np.int32)
    coords[:4] = [[-5, -5], [LT_EXTRACT_SIDE, 3], [7, LT_EXTRACT_SIDE], [0, 0]]
    t1 = time.perf_counter()
    got = native.extract_patches_native(host, coords, PS)
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = np.empty_like(got)
    for i, (y, x) in enumerate(coords):
        y, x = min(max(y, 0), LT_EXTRACT_SIDE - PS), min(max(x, 0), LT_EXTRACT_SIDE - PS)
        want[i] = host[y:y + PS, x:x + PS]
    numpy_s = time.perf_counter() - t1
    if not np.array_equal(got, want):
        raise AssertionError("native patch extraction differs from numpy slicing")
    report["native"] = {"available": True, "setup_build_s": built["s"],
                        "setup_compiled": built["compiled"], "omp_threads":
                        native.omp_threads(), "regions": len(polys), "boxes": LT_NATIVE_BOXES,
                        "clip_max_abs_diff": worst, "clip_native_s": clip["native"],
                        "clip_numpy_s": clip["numpy"], "extract_patches": LT_EXTRACT_N,
                        "extract_native_s": native_s, "extract_numpy_s": numpy_s}
    print(f"phase 23 native: {'compiled' if built['compiled'] else 'loaded from the cache'} in "
          f"the set-up in {built['s']:.2f} s ({native.omp_threads()} threads); clip "
          f"areas of {len(polys)} regions x {LT_NATIVE_BOXES} boxes {clip['native']:.4f} s vs "
          f"numpy {clip['numpy']:.4f} s, max |diff| {worst}; {LT_EXTRACT_N} patches "
          f"{native_s:.4f} s vs numpy {numpy_s:.4f} s, equal (clamped corners included)")
    del slide, host, crop_np
    torch.cuda.empty_cache()
    report["launches"] = launches
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    built = build_native()  # the host gathers of later phases take it: not in their windows
    print(f"build: the native host library "
          f"{'compiled with g++' if built['compiled'] else 'loaded from the cache'} in "
          f"{built['s']:.2f} s")

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

    data_dir = tempfile.TemporaryDirectory()  # phases 18-19 train from its files too
    root = data_dir.name
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
    del one, state

    # 18. the training program: config_vit.yaml (ViT-S/16, depth 6, 196
    # tokens, batch 64) through the CLI's main, with test extraction, then
    # resumed for one more epoch; its checkpoint served by predict_full_fused
    cli = train_cli_phase(Path(root), sampler, device)
    for path, (run_launches, per_step) in cli.pop("launches").items():
        for k in kernels:
            k["launches"] += run_launches.get(k["name"], 0)
            k["launches_by_path"][path] = per_step.get(k["name"], 0)
    print("training programs: " + json.dumps(cli))

    # 20. the predict CLI in each of its modes, at its own settings, on the
    # seeded slide written as a DHS dataset and a checkpoint of the seeded
    # ResNet-18
    t20 = time.perf_counter()
    predicts = predict_cli_phase(Path(root), device)
    for path, run_launches in predicts.pop("launches").items():
        for k in kernels:
            k["launches"] += run_launches.get(k["name"], 0)
            k["launches_by_path"][path] = run_launches.get(k["name"], 0)
    print(f"predict CLI (phase 20, {time.perf_counter() - t20:.1f} s): " + json.dumps(predicts))

    # 21. the serving daemon: a float and an int8 engine over a checkpoint
    # of the seeded ResNet-18 behind HTTP, the streamed predicts, the ViT's
    # serving forms
    t21 = time.perf_counter()
    daemon = daemon_phase(Path(root), device)
    for path, run_launches in daemon.pop("launches").items():
        for k in kernels:
            k["launches"] += run_launches.get(k["name"], 0)
            k["launches_by_path"][path] = run_launches.get(k["name"], 0)
    print(f"serving daemon (phase 21, {time.perf_counter() - t21:.1f} s): " + json.dumps(daemon))

    # 22. the parallel paths: the mesh routes at world 1 over NCCL, then 2
    # ranks over gloo sharing the card
    t22 = time.perf_counter()
    par = parallel_phase(Path(root), pairs, device)
    for path, run_launches in par.pop("launches").items():
        for k in kernels:
            k["launches"] += run_launches.get(k["name"], 0)
            k["launches_by_path"][path] = run_launches.get(k["name"], 0)
    print(f"parallel paths (phase 22, {time.perf_counter() - t22:.1f} s): " + json.dumps(par))

    # 23. the long tail: the exported classifiers, the distributed
    # checkpoints and the daemon over them, the profiler, the native library
    t23 = time.perf_counter()
    tail = long_tail_phase(Path(root), pairs, device)
    for path, run_launches in tail.pop("launches").items():
        for k in kernels:
            k["launches"] += run_launches.get(k["name"], 0)
            k["launches_by_path"][path] = run_launches.get(k["name"], 0)
    print(f"long tail (phase 23, {time.perf_counter() - t23:.1f} s): " + json.dumps(tail))
    data_dir.cleanup()

    print(f"chip_smoke: phases 1-23 in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
