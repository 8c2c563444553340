"""The port's whole-slide samplers (``samplers/full.py``) against the JAX
package's.

* Dense: the batched coordinates equal ``_create_batched_coords`` and the
  patches the JAX sampler's, exactly.
* Random, on the same draws: numpy-made Gumbel noise and jitter replace the
  port's ``_rnd_draws`` and feed a loop over the JAX package's own pieces
  (``lax.top_k``, ``gather_patches_xla``, ``scatter_add_map``,
  ``count_nonzero``): every step's coordinates, patches and filled ratio,
  the step count and the coverage must be equal.
* Random, on the samplers' own generators (torch's streams are not JAX's):
  the step count and the per-cell coverage marks over 24 seeds each, within
  5 standard errors of the two means (cell by cell for the marks).
* ``generator_torch`` is K1's float32 ``u8 · f32(1/255)``, within 1 ulp
  (6e-8) of the JAX sampler's ``u8 / 255``; host mode (a budget of 0
  bytes) and ONDISK over the memory map give the device mode's patches.
* ``visualize_heatmap``: the JAX package's files, byte for byte.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.ops.gather import gather_patches_xla
from deephisto_tpu.ops.stitch import coverage_footprint as jax_coverage_footprint
from deephisto_tpu.ops.stitch import scatter_add_map as jax_scatter_add_map
from deephisto_tpu.samplers import full as jax_full
from deephisto_tpu.slide import ArraySlide as JArraySlide
from deephisto_tpu_torch.samplers import full
from deephisto_tpu_torch.slide import ArraySlide, write_dhs
from test_torch_sampling import _jax_coverage_cells

H, W, PS, BS = 512, 640, 64, 16


@pytest.fixture(scope="module")
def level0():
    return np.random.default_rng(0).integers(0, 255, size=(2 * H, 2 * W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def slides(level0):
    return JArraySlide(level0, max_layer=4), ArraySlide(level0, max_layer=4)


class Draws:
    """numpy-made stand-in for ``samplers.full._rnd_draws``: Gumbel noise and
    jitter from a seeded numpy generator, each step's kept in ``log``."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.log = []

    def __call__(self, gen, n_cells, batch_size, n_jitter):
        noise = self.rng.gumbel(size=n_cells).astype(np.float32)
        jitter = self.rng.integers(0, n_jitter, (2, batch_size))
        self.log.append((noise, jitter))
        return torch.from_numpy(noise), torch.from_numpy(jitter)


def jax_coverage_step(accum, noise, jitter, h, w, bs, ps, d, dense_level, grid=1):
    """One coverage step of the JAX package (full.py:_rnd_coords_step,
    pipeline.py:_predict_random_while's body) on given draws → (coords,
    accum, filled)."""
    cy, cx = _jax_coverage_cells(accum, dense_level, bs, jnp.asarray(noise))
    pd2 = ps // d // 2
    y = jnp.clip((cy - pd2) * d + jitter[0] * grid, 0, (h - ps) // grid * grid)
    x = jnp.clip((cx - pd2) * d + jitter[1] * grid, 0, (w - ps) // grid * grid)
    coords = jnp.stack([y, x], axis=1).astype(jnp.int32)
    accum = jax_scatter_add_map(accum[..., None], coords // d, jnp.ones((bs,), jnp.float32),
                                jax_coverage_footprint(ps, d))[..., 0]
    return coords, accum, jnp.count_nonzero(accum) / accum.size


def test_dense_sampler_matches_jax(slides):
    js, ts = slides
    j = jax_full.FullImageDenseSampler(js, layer=2, patch_size=PS, batch_size=BS, stride=PS // 2)
    t = full.FullImageDenseSampler(ts, layer=2, patch_size=PS, batch_size=BS, stride=PS // 2,
                                   device="cpu")
    want_b, got_b = j._create_batched_coords(), t._create_batched_coords()
    assert len(got_b) == len(want_b)
    for g, w_ in zip(got_b, want_b):
        np.testing.assert_array_equal(g, w_)
    n = 0
    for (gp, gprog), (wp, wprog) in zip(t.generator(), j.generator()):
        assert gprog == wprog and len(gp) == len(wp) == BS
        for a, b in zip(gp, wp):
            assert (a.pos_y, a.pos_x, a.layer, a.patch_size) == (b.pos_y, b.pos_x, b.layer, b.patch_size)
            np.testing.assert_array_equal(a.data, b.data)
        n += 1
    assert n == len(want_b)


@pytest.mark.parametrize("sampler", ["dense", "random"])
def test_generator_torch_is_k1s_float_mode(slides, sampler):
    js, ts = slides
    if sampler == "dense":
        t = full.FullImageDenseSampler(ts, layer=2, patch_size=PS, batch_size=BS, device="cpu")
        j = jax_full.FullImageDenseSampler(js, layer=2, patch_size=PS, batch_size=BS)
        (f, c, _), (jf, jc, _) = next(iter(t.generator_torch())), next(iter(j.generator_torch()))
        np.testing.assert_array_equal(c.numpy(), jc.numpy())
    else:
        t = full.FullImageRndSampler(ts, layer=2, patch_size=PS, batch_size=BS, device="cpu")
        f, c, filled = next(iter(t.generator_torch()))
        assert 0 < filled <= 1 and c.dtype == torch.float32
        layer = ts.get_region_from_layer(2, (0, 0), ts.layer_size(2))
        u8 = np.stack([layer[y:y + PS, x:x + PS] for y, x in c.numpy().astype(int)])
        jf = torch.from_numpy(u8.astype(np.float32) / 255.0)
    assert f.dtype == torch.float32 and f.shape == (BS, PS, PS, 3) and float(f.max()) <= 1.0
    u8 = torch.round(jf * 255).to(torch.uint8)
    np.testing.assert_array_equal(f.numpy(), (u8.float() * torch.tensor(1 / 255.0)).numpy())
    np.testing.assert_allclose(f.numpy(), jf.numpy(), rtol=0, atol=6e-8)


@pytest.mark.parametrize("ps,bs,speedup,size", [(PS, BS, 16, None), (100, 32, 16, 1010),
                                                (8, 64, 16, 256)])
def test_random_sampler_replays_jax_on_the_same_draws(slides, monkeypatch, ps, bs, speedup, size):
    """Awkward sizes included (tests/test_samplers_full.py:200): 1010 % 16 <
    100 % 16, and a patch smaller than the cell."""
    if size is None:
        js, ts, layer = *slides, 2
    else:
        a = np.random.default_rng(2).integers(0, 255, (size, size, 3), dtype=np.uint8)
        js, ts, layer = JArraySlide(a, max_layer=1), ArraySlide(a, max_layer=1), 1
    draws = Draws(7)
    monkeypatch.setattr(full, "_rnd_draws", draws)
    t = full.FullImageRndSampler(ts, layer=layer, patch_size=ps, batch_size=bs, speedup=speedup,
                                 device="cpu")
    got = list(t.device_generator())
    h, w = ts.layer_size(layer)
    image = jnp.asarray(js.get_region_from_layer(layer, (0, 0), (h, w)))
    accum = jnp.zeros((h // speedup, w // speedup), jnp.float32)
    assert len(got) == len(draws.log) and got[-1][2] == 1.0
    for (patches, coords, filled), (noise, jitter) in zip(got, draws.log):
        want_c, accum, want_f = jax_coverage_step(accum, noise, jitter, h, w, bs, ps, speedup, 2)
        np.testing.assert_array_equal(coords.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(patches.numpy(), np.asarray(gather_patches_xla(image, want_c, ps)))
        assert filled == float(want_f)
    np.testing.assert_array_equal(t._accum, np.asarray(accum))
    assert (t._accum > 0).all() and t._filled_ratio == [g[2] for g in got]


def test_random_sampler_prefers_empty_cells(slides):
    t = full.FullImageRndSampler(slides[1], layer=2, patch_size=PS, batch_size=BS, device="cpu")
    ratios = [filled for _, filled in t.seed(5).generator()]
    assert all(b > a for a, b in zip(ratios[:6], ratios[1:6]))
    assert ratios[-1] == 1.0 and (t._accum > 0).all()


def _run(sampler):
    steps = 0
    for _ in sampler.generator():
        steps += 1
    return steps, sampler._accum


def test_random_sampler_distribution_matches_jax(slides):
    """Step counts and per-cell marks over 24 seeds of each package's own
    generator (tests/test_sampler_distribution.py's pattern)."""
    js, ts = slides
    kw = dict(layer=4, patch_size=PS, batch_size=8, speedup=16)
    port = [_run(full.FullImageRndSampler(ts, device="cpu", **kw).seed(s)) for s in range(24)]
    ref = [_run(jax_full.FullImageRndSampler(js, **kw).seed(s)) for s in range(24)]
    for pick in (lambda r: np.asarray([float(r[0])]), lambda r: r[1].ravel()):
        a = np.stack([pick(r) for r in port])
        b = np.stack([pick(r) for r in ref])
        se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
        assert (np.abs(a.mean(0) - b.mean(0)) <= 5 * se + 1e-9).all(), (a.mean(0), b.mean(0))


def test_host_and_ondisk_modes_give_device_patches(level0, tmp_path, monkeypatch):
    path = write_dhs(level0[:H, :W], tmp_path / "s.dhs", max_layer=2)

    def patches(sampler, n=3):
        out = []
        for i, (p, c, _) in enumerate(sampler.device_generator()):
            out.append((p.numpy(), np.asarray(c)))
            if i + 1 == n:
                break
        return out

    def both(mode, **kw):
        rnd = full.FullImageRndSampler(path, layer=1, patch_size=PS, batch_size=BS, mode=mode,
                                       device="cpu", **kw).seed(3)
        dense = full.FullImageDenseSampler(path, layer=1, patch_size=PS, batch_size=BS,
                                           mode=mode, device="cpu")
        return rnd, dense

    ref = [patches(s) for s in both(full.SamplerExecutionMode.INMEMORY_SINGLEPROC)]
    ondisk = both(full.SamplerExecutionMode.ONDISK_MULTIPROC)
    assert all(not s._on_device and isinstance(s.data, np.memmap) for s in ondisk)
    monkeypatch.setattr(full, "DEVICE_SLIDE_BUDGET", 0)
    host = both(full.SamplerExecutionMode.INMEMORY_SINGLEPROC)
    assert all(not s._on_device for s in host)
    for samplers in (ondisk, host):
        for want, s in zip(ref, samplers):
            for (wp, wc), (gp, gc) in zip(want, patches(s)):
                np.testing.assert_array_equal(gc, wc)
                np.testing.assert_array_equal(gp, wp)


def test_visualizations(slides, tmp_path):
    from deephisto_tpu_torch._imageio import read_png

    t = full.FullImageRndSampler(slides[1], layer=2, patch_size=PS, batch_size=64,
                                 device="cpu").seed(1)
    for _ in t.generator():
        pass
    t.visualize_heatmap(str(tmp_path / "heat.png"))  # saved by its extension: PNG, lossless
    heat, mask = read_png(tmp_path / "heat.png")[..., 0], read_png(tmp_path / "_heat.png")[..., 0]
    np.testing.assert_array_equal(heat, (t._accum / t._accum.max() * 255).astype(np.uint8))
    np.testing.assert_array_equal(mask, np.where(heat > 0, 255, 0))
    drawn = t.plot_empty_area_history(str(tmp_path / "hist.jpg"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert drawn is False
    else:
        assert drawn and (tmp_path / "hist.jpg").exists()



@pytest.mark.parametrize("name", ["heat.jpg", "heat.png"])
def test_heatmap_is_the_jax_packages_files(slides, tmp_path, name):
    """``visualize_heatmap`` writes, byte for byte, the files the JAX
    package's writes from the same accumulator: the heatmap in the format of
    the name's extension and its ``_`` companion at quality 98."""
    t = full.FullImageRndSampler(slides[1], layer=2, patch_size=PS, batch_size=64,
                                 device="cpu").seed(1)
    for _ in t.generator():
        pass
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    t.visualize_heatmap(str(tmp_path / "port" / name))
    jax_full.FullImageRndSampler.visualize_heatmap(SimpleNamespace(_accum=np.asarray(t._accum)),
                                                   str(tmp_path / "jax" / name))
    for f in (name, "_" + name):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f

def test_small_layer_is_refused(slides):
    with pytest.raises(ValueError, match="smaller than"):
        full.FullImageRndSampler(slides[1], layer=4, patch_size=300, batch_size=BS, device="cpu")
    with pytest.raises(ValueError, match="smaller than"):
        full.FullImageDenseSampler(slides[1], layer=4, patch_size=300, batch_size=BS, device="cpu")
