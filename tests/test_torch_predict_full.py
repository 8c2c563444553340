"""The port's full-WSI predictors (``predict/full_patched.py`` and
``predict/pipeline.py:predict_full_random_fused``) against the JAX package's,
with the same narrow float32 ResNet-18 (flax weights converted).

* ``process_on_device``, ``ImagePredictorPatched`` + ``batch_predictor`` and
  the count normalization on the dense sampler: argmax maps bit-equal.
* The random predict against a replay: numpy-made cell noise and jitter
  replace the port's draws; the oracle is a loop over the JAX package's own
  pieces (``lax.top_k``, ``gather_patches_xla``, ``model_input``,
  ``model.apply``, ``scatter_add_map_exact``, ``scatter_add_map``,
  ``count_nonzero``) on the same draws, stopping as its while loop does.
  Steps, filled and coverage equal; scores within rtol = atol = 1e-4 (the
  bound of tests/test_torch_pipeline.py for the same model: two float32
  forwards that order their conv sums differently); argmax bit-equal on
  every cell whose top-2 margin exceeds 1e-3. The plain and the PackedSlide
  branches, and a ``max_steps`` cut.
* ``perform_and_save_visualizations``: the mask and the preview are the
  JAX package's arrays (its formula, its PIL resize), the overlay
  ``(img * 0.6 + colored * 0.4).astype(uint8)``, each as Pillow's JPEG at
  quality 95; the three files byte-equal to the ones the JAX package
  writes from the same slide and map.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_resnet import flax_and_torch_resnet
from test_torch_samplers_full import Draws

from deephisto_tpu.anno import AnnoDescription as JAnnoDescription
from deephisto_tpu.ops.gather import gather_patches_xla
from deephisto_tpu.ops.stitch import coverage_footprint, scatter_add_map, scatter_add_map_exact
from deephisto_tpu.predict import full_patched as jax_fp
from deephisto_tpu.predict import pipeline as jax_pipeline
from deephisto_tpu.samplers import full as jax_full
from deephisto_tpu.slide import ArraySlide as JArraySlide
from deephisto_tpu.slide import DEFAULT_COLORS
from deephisto_tpu_torch.anno import AnnoDescription
from deephisto_tpu_torch.predict import (
    ImagePredictorPatched,
    batch_predictor,
    perform_and_save_visualizations,
    predict_full_random_fused,
    process_on_device,
    stage_packed_slide,
)
from deephisto_tpu_torch.samplers import full
from deephisto_tpu_torch.slide import ArraySlide
from test_torch_sampling import _jax_coverage_cells

TOL = dict(rtol=1e-4, atol=1e-4)
PS, BS = 64, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six workers on the host's cores, and
    the many small ops of these predicts slow down by an order of magnitude
    when each worker's pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def level0():
    """Noise over a 6 × 7 grid of random block colours: the blocks give the
    class map structure to agree on."""
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 160, (6, 7, 3), dtype=np.uint8).repeat(64, 0).repeat(64, 1)
    return blocks + rng.integers(0, 96, (384, 448, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models(level0):
    """Narrow float32 ResNet-18s, flax and converted, with the fc bias
    shifted in both so that the logits are centred over the slide's
    patches (a random trunk makes one class win every patch otherwise)."""
    out = {}
    for stem in ("imagenet", "s2d"):
        jm, v, tm = flax_and_torch_resnet(18, stem=stem, size=PS, seed=3)
        x = np.stack([level0[y:y + PS, x:x + PS] for y in range(0, 320, 64)
                      for x in range(0, 384, 64)]).astype(np.float32) / 255
        with torch.no_grad():
            shift = tm(torch.from_numpy(x)).mean(0)
            tm.fc.bias -= shift
        v["params"]["fc"]["bias"] = v["params"]["fc"]["bias"] - shift.numpy()
        out[stem] = (jm, v, tm)
    return out


def _decided(scores, margin=1e-3):
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


@pytest.mark.parametrize("softmax,normalize", [(False, False), (True, True)])
def test_process_on_device_matches_jax(level0, models, softmax, normalize):
    jm, v, tm = models["imagenet"]
    js, ts = JArraySlide(level0, max_layer=2), ArraySlide(level0, max_layer=2)
    kw = dict(layer=1, patch_size=PS, batch_size=BS, stride=48)
    want = jax_fp.process_on_device(jax_full.FullImageDenseSampler(js, **kw), jm, v, 5,
                                    downscale=8, softmax=softmax, normalize_counts=normalize,
                                    verbose=False)
    got = process_on_device(full.FullImageDenseSampler(ts, device="cpu", **kw), tm, 5,
                            downscale=8, softmax=softmax, normalize_counts=normalize,
                            verbose=False)
    assert got.dtype == np.uint8 and got.shape == (384 // 8, 448 // 8)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_image_predictor_patched_matches_jax(level0, models):
    jm, v, tm = models["imagenet"]
    js, ts = JArraySlide(level0, max_layer=2), ArraySlide(level0, max_layer=2)
    kw = dict(layer=1, patch_size=PS, batch_size=BS, stride=40)
    jd = JAnnoDescription.with_known_colors(DEFAULT_COLORS)
    td = AnnoDescription.with_known_colors(DEFAULT_COLORS)
    want = jax_fp.ImagePredictorPatched(
        js, jax_full.FullImageDenseSampler(js, **kw).generator(),
        lambda p: jax_fp.batch_predictor(p, jm, v), jd, layer=1, downscale=8).process(verbose=False)
    got = ImagePredictorPatched(
        ts, full.FullImageDenseSampler(ts, device="cpu", **kw).generator(),
        lambda p: batch_predictor(p, tm), td, layer=1, downscale=8, device="cpu",
    ).process(verbose=False)
    np.testing.assert_array_equal(got, want)
    patches = next(full.FullImageDenseSampler(ts, device="cpu", **kw).generator())[0]
    np.testing.assert_allclose(batch_predictor(patches, tm), jax_fp.batch_predictor(patches, jm, v),
                               **TOL)


def _replay(image, jm, v, draws, h, w, ps, bs, d, speedup, max_steps, packed):
    """The JAX random predict's loop (pipeline.py:_predict_random_while) on
    the draws the port took, op by op."""
    dh, dw = h // speedup, w // speedup
    accum = jnp.zeros((dh, dw), jnp.float32)
    pred = jnp.zeros((h // d, w // d, 5), jnp.float32)
    filled, steps = 0.0, 0
    grid = 4 if packed else 1
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    for noise, jitter in draws:
        if not (filled < 1.0 and steps < max_steps):
            break
        cy, cx = _jax_coverage_cells(accum, 2, bs, jnp.asarray(noise))
        pd2 = ps // speedup // 2
        y = jnp.clip((cy - pd2) * speedup + jitter[0] * grid, 0, (h - ps) // grid * grid)
        x = jnp.clip((cx - pd2) * speedup + jitter[1] * grid, 0, (w - ps) // grid * grid)
        coords = jnp.stack([y, x], axis=1).astype(jnp.int32)
        patches = gather_patches_xla(image, coords // grid, ps // grid)
        logits = jm.apply(variables, jax_pipeline.model_input(jm, patches), train=False,
                          **({"pre_packed": True} if packed else {}))
        pred = scatter_add_map_exact(pred, coords, logits, ps, d)
        accum = scatter_add_map(accum[..., None], coords // speedup,
                                jnp.ones((bs,), jnp.float32), coverage_footprint(ps, speedup))[..., 0]
        filled = float(jnp.count_nonzero(accum) / accum.size)
        steps += 1
    return np.asarray(pred), np.asarray(accum), filled, steps


@pytest.mark.parametrize("stem,packed,max_steps", [("imagenet", False, None),
                                                   ("s2d", True, None),
                                                   ("imagenet", False, 2)])
def test_random_predict_matches_a_jax_replay(level0, models, monkeypatch, stem, packed, max_steps):
    jm, v, tm = models[stem]
    draws = Draws(5)
    monkeypatch.setattr(full, "_rnd_draws", draws)
    kw = dict(patch_size=PS, batch_size=BS, downscale=8, speedup=16, max_steps=max_steps)
    image = stage_packed_slide(level0, device="cpu") if packed else level0
    with jax.disable_jit():
        got_map, got_scores, got_cov, got_filled, got_steps = predict_full_random_fused(
            image, tm, 5, device="cpu", **kw)
        jimage = jax_pipeline.stage_packed_slide(level0).packed if packed else jnp.asarray(level0)
        want_scores, want_cov, want_filled, want_steps = _replay(
            jimage, jm, v, draws.log, 384, 448, PS, BS, 8, 16, max_steps or 10**9, packed)
    if max_steps is None:
        assert got_filled == want_filled == 1.0 and len(draws.log) == got_steps > 2
    else:
        assert got_steps == max_steps and got_filled < 1.0
    assert (got_steps, got_filled) == (want_steps, want_filled)
    np.testing.assert_array_equal(got_cov, want_cov)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, **TOL)
    # cells no patch covered (a max_steps cut) hold 0 on both sides
    decided = _decided(want_scores) | (want_scores == 0).all(-1)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got_map[decided], np.argmax(want_scores, -1)[decided])


def test_random_predict_on_its_own_generator(level0, models):
    _, _, tm = models["imagenet"]
    out = [predict_full_random_fused(level0, tm, 5, patch_size=PS, batch_size=BS, downscale=8,
                                     seed=s, device="cpu") for s in (0, 0, 1)]
    for m, scores, cov, filled, steps in out:
        assert filled == 1.0 and (cov > 0).all() and m.shape == (48, 56) and steps >= 3
    np.testing.assert_array_equal(out[0][1].numpy(), out[1][1].numpy())  # seeded
    assert not np.array_equal(out[0][2], out[2][2])


@pytest.mark.parametrize("max_steps", [None, 3])
def test_random_predict_draws_only_the_steps_it_takes(level0, models, monkeypatch,
                                                      max_steps):
    """The loop stops on the while loop's rule: after the first step whose
    filled ratio reaches 1.0, or at ``max_steps``, drawing no step past it;
    a second run on the same draws gives the same outputs bit for bit."""
    _, _, tm = models["imagenet"]
    kw = dict(patch_size=PS, batch_size=BS, downscale=8, max_steps=max_steps, device="cpu")
    out = []
    for _ in range(2):
        draws = Draws(0)
        monkeypatch.setattr(full, "_rnd_draws", draws)
        out.append(predict_full_random_fused(level0, tm, 5, **kw))
        _, _, cov, filled, steps = out[-1]
        assert len(draws.log) == steps
        if max_steps is None:
            assert filled == 1.0 and (cov > 0).all()
        else:
            assert steps == max_steps and filled < 1.0
    got, want = out
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and got[3:] == want[3:]
    np.testing.assert_array_equal(got[2], want[2])


def test_visualizations_match_jax(tmp_path, level0):
    js, ts = JArraySlide(level0, max_layer=2), ArraySlide(level0, max_layer=2)
    pred = np.random.default_rng(2).integers(0, 5, (24, 28), dtype=np.uint8)
    desc = AnnoDescription.with_known_colors(DEFAULT_COLORS)
    paths = perform_and_save_visualizations(ts, desc, pred, out_dir=tmp_path / "out")
    assert [p.name for p in paths.values()] == ["slide_mask.jpg", "slide.jpg", "slide_overlay.jpg"]
    colored = np.zeros((24, 28, 3), dtype=np.uint8)
    for c in JAnnoDescription.with_known_colors(DEFAULT_COLORS).anno_classes:
        colored[pred == c.id] = c.color
    img = js.get_region((0, 0), (js.height, js.width), target_hw=(24, 28))
    # each file is the JAX package's array as Pillow's JPEG at quality 95
    for key, want in (("mask", colored), ("original", img),
                      ("overlay", (img * 0.6 + colored * 0.4).astype(np.uint8))):
        buf = io.BytesIO()
        Image.fromarray(want).save(buf, format="JPEG", quality=95)
        assert paths[key].read_bytes() == buf.getvalue(), key


def test_visualizations_are_the_jax_packages_files(tmp_path, level0):
    """The three images are byte for byte the files the JAX package writes
    from the same slide and map (names and JPEG bytes)."""
    js, ts = JArraySlide(level0, max_layer=2), ArraySlide(level0, max_layer=2)
    pred = np.random.default_rng(3).integers(0, 5, (24, 28), dtype=np.uint8)
    got = perform_and_save_visualizations(ts, AnnoDescription.with_known_colors(DEFAULT_COLORS),
                                          pred, out_dir=tmp_path / "port")
    want = jax_fp.perform_and_save_visualizations(
        js, JAnnoDescription.with_known_colors(DEFAULT_COLORS), pred, out_dir=tmp_path / "jax")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].name == want[key].name
        assert got[key].read_bytes() == want[key].read_bytes(), key


def test_random_predict_refusals(level0, models):
    _, _, tm = models["imagenet"]
    with pytest.raises(ValueError, match="s2d"):
        predict_full_random_fused(stage_packed_slide(level0, device="cpu"), tm, 5, device="cpu")
    with pytest.raises(ValueError, match="4-aligned"):
        predict_full_random_fused(stage_packed_slide(level0, device="cpu"), models["s2d"][2], 5,
                                  patch_size=62, device="cpu")
    with pytest.raises(ValueError, match="255"):
        predict_full_random_fused(level0, tm, 256, device="cpu")
    with pytest.raises(ValueError, match="smaller than"):
        predict_full_random_fused(level0[:50], tm, 5, patch_size=PS, device="cpu")
