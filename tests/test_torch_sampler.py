"""The port's sampler stack (slides, annotations, region table, device
geometry, slide bank, the random region sampler and K1's multi-slide gather)
against the JAX package's, on the CPU.

Both packages read the same dataset files, written by the JAX package's
``ensure_synthetic_dataset`` (the port's own generator fills polygons with
numpy, not PIL, so its pixels differ at outlines; its annotations are the
same, which one test checks).

* Exact: the DHS slides as read, the slide bank, the region table (every
  array of ``build_region_table``), the sampler's log-weight matrices, and
  K1's multi-slide plain version vs ``gather_patches_multi_xla`` (uint8,
  bit for bit, starts clamped as ``lax.dynamic_slice`` clamps them).
* ``clip_area_batch`` vs the JAX one on random star polygons and boxes:
  within 2e-2 px² (float32 areas up to ps² = 4096, each the difference of
  two shoelace sums of 5V products up to ps², reduced in other orders;
  readings 0 to 7.8e-3; a decision against ps²·ri flips only for an area
  that close to the threshold).
* torch's random streams are not JAX's, so the sampling step is held to the
  JAX sampler's distribution tests (tests/test_samplers_region.py,
  tests/test_sampler_distribution.py): class balance, every patch's clip area
  above ps²·region_intersection for a region of its class on its image, a
  forced class (0 included), one image a batch, determinism under a seeded
  generator, clamped context windows; and the fused epoch's presampled
  coordinates equal the per-step ones.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.anno.parse import parse_annotations as jax_parse
from deephisto_tpu.geometry import clip_area_box
from deephisto_tpu.geometry.device import clip_area_batch as jax_clip_area_batch
from deephisto_tpu.ops.gather import gather_patches_multi_xla
from deephisto_tpu.samplers import AnnoRegionRndSampler as JaxSampler
from deephisto_tpu.samplers import SlideBank as JaxBank
from deephisto_tpu.samplers.region import build_region_table as jax_build_table
from deephisto_tpu.slide import make_synthetic_slide as jax_make_slide
from deephisto_tpu.slide import open_slide as jax_open_slide
from deephisto_tpu.slide import star_polygon
from deephisto_tpu_torch.anno import parse_annotations
from deephisto_tpu_torch.geometry import clip_area_batch, polygon_mask
from deephisto_tpu_torch.models.patch_cls_simple import make_fused_epoch
from deephisto_tpu_torch.models.vit import ViT
from deephisto_tpu_torch.ops import gather_multi_u8
from deephisto_tpu_torch.samplers import AnnoRegionRndSampler, SlideBank
from deephisto_tpu_torch.samplers.region import build_region_table
from deephisto_tpu_torch.slide import make_synthetic_slide, open_slide
from deephisto_tpu_torch.train import create_train_state
from deephisto_tpu_torch.utils import get_img_ano_paths

PS = 64
LAYER = 2
RI = 0.75


@pytest.fixture(scope="module")
def pairs(synthetic_dataset):
    return get_img_ano_paths(synthetic_dataset, "train")


@pytest.fixture(scope="module")
def sampler(pairs):
    return AnnoRegionRndSampler(pairs, layer=LAYER, patch_size=PS, seed=7, verbose=False,
                                device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_slides_and_bank_read_as_the_jax_package_reads_them(pairs):
    for path, _ in pairs:
        with open_slide(path) as a, jax_open_slide(path) as b:
            assert a.layers == b.layers and a.layer_size(LAYER) == b.layer_size(LAYER)
            h, w = a.layer_size(LAYER)
            np.testing.assert_array_equal(a.get_region_from_layer(LAYER, (0, 0), (h, w)),
                                          b.get_region_from_layer(LAYER, (0, 0), (h, w)))
    bank = SlideBank([p for p, _ in pairs], layer=LAYER, device="cpu")
    want = JaxBank([p for p, _ in pairs], layer=LAYER)
    assert bank.images.dtype == torch.uint8
    np.testing.assert_array_equal(bank.images.numpy(), np.asarray(want.images))
    np.testing.assert_array_equal(bank.layer_hw_arr, want.layer_hw_arr)
    # over its budget the bank stays on the host, as the JAX package's does
    host = SlideBank([p for p, _ in pairs], layer=LAYER, device="cpu", budget_bytes=1000)
    jax_host = JaxBank([p for p, _ in pairs], layer=LAYER, budget_bytes=1000)
    assert not host.on_device and not jax_host.on_device
    np.testing.assert_array_equal(host.images, jax_host.images)


def test_region_table_and_weights_equal_jax(pairs, sampler):
    regions, _ = parse_annotations(pairs, layer=LAYER, verbose=False)
    jregions, _ = jax_parse(pairs, layer=LAYER, verbose=False)
    classes = sorted(regions)
    assert classes == sorted(jregions)
    got, flat = build_region_table(regions, classes, PS, RI, device="cpu")
    want, jflat = jax_build_table(jregions, classes, PS, RI)
    assert len(flat) == len(jflat) and got.max_v == want.max_v
    np.testing.assert_array_equal(got.feasible, want.feasible)
    for field in ("verts", "area", "class_idx", "image_idx", "sample_lo", "sample_hi",
                  "anchors", "n_anchors", "cells", "n_cells", "cell_step"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    js = JaxSampler(pairs, layer=LAYER, patch_size=PS, seed=7, verbose=False)
    for name in ("_logw_cls_region", "_logw_img_cls_region", "_cls_available",
                 "_img_cls_available", "_logw_img_all"):
        np.testing.assert_array_equal(getattr(sampler, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert len(sampler) == len(js)


def test_clip_area_batch_matches_jax():
    rng = np.random.default_rng(0)
    polys = [star_polygon(rng, (200, 200), 120, 12).astype(np.float32) for _ in range(64)]
    verts = np.stack(polys + [np.concatenate([p[:9], np.repeat(p[8:9], 3, 0)]) for p in polys])
    xy = rng.uniform(40, 300, (len(verts), 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + PS], axis=1).astype(np.float32)
    got = clip_area_batch(torch.from_numpy(verts), torch.from_numpy(boxes)).numpy()
    want = np.asarray(jax_clip_area_batch(jnp.asarray(verts), jnp.asarray(boxes)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert (got > 0).any() and (got < PS * PS).any()


def test_gather_multi_plain_matches_xla_gather():
    rng = np.random.default_rng(1)
    bank = rng.integers(0, 256, (3, 90, 110, 3), dtype=np.uint8)
    coords = rng.integers(-30, 130, (40, 2)).astype(np.int32)
    idx = rng.integers(-2, 5, 40).astype(np.int32)
    for ps in (17, 32):
        want = np.asarray(gather_patches_multi_xla(jnp.asarray(bank), jnp.asarray(idx),
                                                   jnp.asarray(coords), ps))
        got = gather_multi_u8(torch.from_numpy(bank), idx, coords, ps)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int32"):
        gather_multi_u8(torch.from_numpy(bank), idx.astype(np.int64), coords, 17)


def test_synthetic_slides_keep_the_jax_annotations_without_pil():
    a, annos = make_synthetic_slide(seed=5, height=300, width=360, max_layer=2)
    b, jannos = jax_make_slide(seed=5, height=300, width=360, max_layer=2)
    assert json.dumps(annos) == json.dumps(jannos)
    same = (a._pyramid[1] == b._pyramid[1]).all(-1).mean()
    assert same > 0.97, same  # the fills differ only along outlines
    rng = np.random.default_rng(2)
    poly = star_polygon(rng, (50, 60), 30, 10)
    from deephisto_tpu.geometry import polygon_mask as pil_mask

    m, want = polygon_mask(poly, 120, 130), pil_mask(poly, 120, 130)
    assert m.dtype == bool and (m != want).mean() < 0.02 and m.sum() > 0.9 * want.sum()


def _patch_ok(s, cls_idx, img, y, x):
    """The largest clip area of the patch with a region of its class on its
    image, and whether it passes the sampler's threshold."""
    best = max(
        (clip_area_box(r.vertices_layer, x, y, x + s.patch_size, y + s.patch_size)
         for r in s.regions[s.classes[cls_idx]] if r.image_idx == img),
        default=0.0,
    )
    return best > s.patch_size**2 * s.region_intersection


def test_patches_are_valid_balanced_and_gathered(sampler):
    fn = sampler.make_sample_fn(32)
    counts = np.zeros(len(sampler.classes), int)
    for seed in range(4):
        patches, labels, coords, img = fn(_gen(seed))
        assert patches.shape == (32, PS, PS, 3) and patches.dtype == torch.uint8
        assert labels.dtype == coords.dtype == img.dtype == torch.int32
        for c, i, (y, x) in zip(labels.tolist(), img.tolist(), coords.tolist()):
            assert _patch_ok(sampler, c, i, y, x), (c, i, y, x)
        counts += np.bincount(labels.numpy(), minlength=len(counts))
        want = gather_multi_u8(sampler.bank.images, img, coords, PS)
        assert torch.equal(patches, want)
        assert torch.equal(sampler.make_gather_fn()(img, coords), want)
    assert counts.min() > 0 and counts.max() / counts.sum() < 0.5, counts


def test_forced_class_deterministic_and_seeded(sampler):
    _, labels, _, _ = sampler.make_sample_fn(16, forced_cls=0)(_gen(1))
    assert (labels == 0).all()
    fn = sampler.make_sample_fn(8, gather=False)
    a, b, c = fn(_gen(5)), fn(_gen(5)), fn(_gen(6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    first, again = sampler.sample_batch(4), sampler.sample_batch(4)
    assert not torch.equal(first[2], again[2])  # the sampler's own generator moves on


def test_one_image_for_batch(pairs):
    s = AnnoRegionRndSampler(pairs, layer=LAYER, patch_size=PS, one_image_for_batch=True,
                             seed=1, verbose=False, device="cpu")
    seen = set()
    for seed in range(6):
        labels, coords, img = s.make_sample_fn(12, gather=False)(_gen(seed))
        assert len(set(img.tolist())) == 1
        seen |= set(img.tolist())
        for c, i, (y, x) in zip(labels.tolist(), img.tolist(), coords.tolist()):
            assert _patch_ok(s, c, i, y, x)
    assert len(seen) == 2  # both images get batches


def test_context_windows_are_clamped_to_the_layer(sampler):
    ctx = 40
    win = PS + 2 * ctx
    windows, labels, coords, img = sampler.make_sample_fn(16, context=ctx)(_gen(3))
    labels2, coords2, img2 = sampler.make_sample_fn(16, gather=False)(_gen(3))
    assert torch.equal(labels, labels2) and torch.equal(coords, coords2)
    assert windows.shape == (16, win, win, 3)
    hw = sampler.bank.layer_hw_arr
    bank = sampler.bank.images.numpy()
    for k, (i, (y, x)) in enumerate(zip(img.tolist(), coords.tolist())):
        y0 = min(max(y - ctx, 0), hw[i][0] - win)
        x0 = min(max(x - ctx, 0), hw[i][1] - win)
        np.testing.assert_array_equal(windows[k].numpy(), bank[i, y0:y0 + win, x0:x0 + win])
    with pytest.raises(ValueError, match="exceeds a slide layer"):
        sampler.make_sample_fn(4, context=1000)


def test_presampled_coords_and_epoch_equal_the_per_step_ones(pairs):
    """``sample_coords`` over several generators gives each batch what the
    per-step sampler gives from that generator alone, so the fused epoch's
    presampled path trains on the same patches as its per-step path."""
    s = AnnoRegionRndSampler(pairs, layer=1, patch_size=32, seed=0, verbose=False,
                             device="cpu")
    labels, coords, img = s.sample_coords([_gen(10 + i) for i in range(3)], 10)
    for i in range(3):
        one = s.make_sample_fn(10, gather=False)(_gen(10 + i))
        assert all(torch.equal(a, b[i]) for a, b in zip(one, (labels, coords, img)))
    losses = []
    for chunk in (0, 2):
        torch.manual_seed(0)
        model = ViT(num_classes=5, patch=8, dim=32, depth=1, heads=2, dtype=torch.float32,
                    stem="conv", img_size=32)
        state = create_train_state(model, 1e-3)
        epoch = make_fused_epoch(model, s, 4, 3, crop_pad=4, label_smoothing=0.1,
                                 presample_chunk=chunk)
        state, l, c = epoch(state, _gen(3))
        assert torch.isfinite(l).all() and state.step == 3
        losses.append(l)
    assert torch.equal(losses[0], losses[1])
