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
9. profile of one ViT predict, by kernel group.

Phase 3 also holds K3 (flash attention) against its plain version in bf16
and f32 at the ViT's shape (256, 6, 784, 64), a ragged N = 1000, N = 196
and Dh 16 and 32, times it beside its FLOP bound, its plain version and
``F.scaled_dot_product_attention`` (a yardstick only: the port never calls
it), and times K3, the plain jnp-branch attention and SDPA at 196 and 784
tokens.

It prints the card line, then one ``{"kernels": [...]}`` line, then as its
last line ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
    ("flash_fwd", "K3 flash_attention"), ("layer_norm", "LayerNorm"), ("gelu", "GELU"),
    ("batch_norm", "batch norm"), ("addpadding", "cuDNN input padding"),
    ("fprop", "convolution"), ("conv", "convolution"), ("max_pool", "max pool"),
    ("gemm", "GEMM (Dense)"), ("nvjet", "GEMM (Dense)"), ("cutlass", "GEMM (Dense)"),
    ("xmma", "GEMM (Dense)"), ("clamp", "relu"), ("copy", "dtype casts / copies"),
    ("add", "residual / bias add"), ("reduce", "mean / argmax"), ("fill", "fill / memset"),
    ("memset", "fill / memset"),
)


def profile_main_path(slide, model) -> dict:
    """Device time of one predict by kernel group, and the card's busy share
    (union of kernel intervals over the profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from deephisto_tpu_torch.predict import predict_full_fused

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_full_fused(slide, model, N_CLASSES)
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
    kernels = [check_k1(slide, dense), check_k2(dense, device), check_k3(device)]
    for k in kernels:
        k["launches"] = 0
        k["launches_by_path"] = {}

    # 4. main path
    model = seeded_model(device, depth=18)
    n_patches = len(dense)
    center_head(model, model.fc, slide, dense[:: n_patches // 64][:64])
    launches, runs, warm_s, best_s, peak_gib, argmax_map = run_main_path(
        slide, model, MAIN_SIDE, "ResNet-18 path")
    for k in kernels[:2]:
        if launches.get(k["name"], 0) == 0:
            raise AssertionError(f"the main path never launched {k['name']}")
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
    for k in kernels:
        if launches.get(k["name"], 0) == 0:
            raise AssertionError(f"the ViT path never launched {k['name']}")
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

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
