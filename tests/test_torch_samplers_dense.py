"""The port's dense sampler, generator APIs, multi-magnification bank, host
bank and test-set extraction against the JAX package's, on the CPU, over the
JAX-written conftest dataset. Every comparison is exact: these are integer
geometry and copies of uint8 pixels (the feature batches divide by 255 in
float32 in both packages).

* ``AnnoRegionDenseSampler.all_coords`` equals JAX's; its
  ``structs_generator`` and ``device_generator`` batches equal JAX's
  ``structs_generator`` and ``jax_generator``, the padded last batch too.
* ``MultiMagBank.gather`` and ``stack_mags_as_channels`` equal JAX's on the
  same coords, edges included.
* A host-mode bank (asked for, or over its budget) gathers what the
  device-mode bank on the CPU and the JAX bank gather; a region sampler over
  it samples batches with ``sample_batch`` and the generator APIs and
  refuses a device-only sample function.
* ``extract_and_save_subset`` writes ``patches_per_class`` JPEGs a feasible
  class, each Pillow's file of the slide's pixels at the coords the sampler
  drew, inside a region of its class by the stated intersection; an
  infeasible class leaves an empty folder.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deephisto_tpu.samplers import AnnoRegionDenseSampler as JDense
from deephisto_tpu.samplers import SlideBank as JBank
from deephisto_tpu.samplers.multimag import MultiMagBank as JMultiMag
from deephisto_tpu.samplers.multimag import stack_mags_as_channels as jax_stack
from deephisto_tpu_torch.geometry import clip_area_boxes
from deephisto_tpu_torch.samplers import (
    AnnoRegionDenseSampler,
    AnnoRegionRndSampler,
    MultiMagBank,
    SlideBank,
    extract_and_save_subset,
    make_multimag_sample_fn,
    stack_mags_as_channels,
)
from deephisto_tpu_torch.slide import open_slide
from deephisto_tpu_torch.utils import get_img_ano_paths

LAYER, PS = 2, 32


@pytest.fixture(scope="module")
def pairs(synthetic_dataset):
    return get_img_ano_paths(synthetic_dataset, "train")


def _random_coords(bank_hw, n, ps, seed):
    """(slide_idx, coords) inside and at the edges of each slide's layer."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, len(bank_hw), n).astype(np.int32)
    hi = np.asarray(bank_hw)[s] - ps
    c = (rng.uniform(size=(n, 2)) * (hi + 1)).astype(np.int32)
    c[:2] = 0
    c[2] = hi[2]
    return s, c


def test_dense_sampler_matches_jax(pairs):
    kw = dict(layer=LAYER, patch_size=PS, stride=24, verbose=False)
    port, jax_s = AnnoRegionDenseSampler(pairs, device="cpu", **kw), JDense(pairs, **kw)
    got, want = port.all_coords(), jax_s.all_coords()
    assert len(got[0]) > 20 and port.classes == jax_s.classes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n = 0
    for (pp, pc), (jp, jc) in zip(port.structs_generator(), jax_s.structs_generator(), strict=True):
        assert pc == jc and (pp.pos_x, pp.pos_y, pp.layer, pp.patch_size) == (
            jp.pos_x, jp.pos_y, jp.layer, jp.patch_size)
        np.testing.assert_array_equal(pp.data, jp.data)
        n += 1
    assert n == len(got[0])
    batches = list(zip(port.device_generator(7), jax_s.jax_generator(7), strict=True))
    assert len(batches) == -(-n // 7)
    for (f, lab, c), (jf, jlab, jc) in batches:
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert f.dtype == torch.float32 and c.dtype == torch.float32


def test_multimag_gather_matches_jax(pairs):
    paths = [p for p, _ in pairs]
    port, jax_b = MultiMagBank(paths, (1, 2, 4), device="cpu"), JMultiMag(paths, (1, 2, 4))
    s, c = _random_coords(port.banks[LAYER].layer_hw, 12, PS, seed=0)
    got = port.gather(torch.from_numpy(s), torch.from_numpy(c), PS, LAYER)
    want = jax_b.gather(jnp.asarray(s), jnp.asarray(c), PS, LAYER)
    assert got.shape == (12, 3, PS, PS, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(stack_mags_as_channels(got).numpy(), np.asarray(jax_stack(want)))


def test_multimag_sample_fn_refuses_host_banks(pairs):
    paths = [p for p, _ in pairs]
    sampler = AnnoRegionRndSampler(pairs, layer=LAYER, patch_size=PS, device="cpu", verbose=False)
    mm = MultiMagBank(paths, (1, 2), device="cpu")
    patches, labels, coords, img = make_multimag_sample_fn(sampler, mm, 8)(
        torch.Generator().manual_seed(0))
    assert patches.shape == (8, PS, PS, 6) and labels.shape == (8,)
    np.testing.assert_array_equal(
        patches[..., 3:].numpy(), mm.banks[2].gather(img, coords, PS).numpy())
    mm.banks[1] = SlideBank(paths, layer=1, device="cpu", budget_bytes=0)
    with pytest.raises(ValueError, match="host"):
        make_multimag_sample_fn(sampler, mm, 8)


def test_host_bank_gathers_as_the_device_bank_and_jax(pairs, capsys):
    paths = [p for p, _ in pairs]
    dev = SlideBank(paths, layer=LAYER, device="cpu")
    host = SlideBank(paths, layer=LAYER, device="cpu", budget_bytes=0)
    over = SlideBank(paths, layer=LAYER, device="cpu", budget_bytes=1024)
    assert dev.on_device and not host.on_device and not over.on_device
    assert "on the host" in capsys.readouterr().out
    assert isinstance(host.images, np.ndarray)
    s, c = _random_coords(dev.layer_hw, 16, PS, seed=1)
    c[3] = (-5, 10_000)  # clamped as lax.dynamic_slice clamps
    want = dev.gather(s, c, PS).numpy()
    np.testing.assert_array_equal(host.gather(s, c, PS).numpy(), want)
    np.testing.assert_array_equal(over.gather(s, c, PS).numpy(), want)
    np.testing.assert_array_equal(np.asarray(JBank(paths, layer=LAYER).gather(s, c, PS)), want)


def test_region_sampler_on_a_host_bank(pairs):
    bank = SlideBank([p for p, _ in pairs], layer=LAYER, device="cpu", budget_bytes=0)
    s = AnnoRegionRndSampler(pairs, layer=LAYER, patch_size=PS, slide_bank=bank, seed=3,
                             verbose=False)
    patches, labels, coords, img = s.sample_batch(6)
    assert patches.shape == (6, PS, PS, 3)
    np.testing.assert_array_equal(patches.numpy(), bank.gather(img, coords, PS).numpy())
    with pytest.raises(ValueError, match="device-resident"):
        s.make_sample_fn(6)
    with pytest.raises(ValueError, match="device-resident"):
        s.make_gather_fn()
    batch = next(s.structs_generator(5, 1))
    assert len(batch) == 5 and batch[0][0].data.shape == (PS, PS, 3)
    f, lab, c = next(s.torch_generator(4, 1))
    assert f.shape == (4, PS, PS, 3) and f.dtype == torch.float32 and lab.dtype == torch.int64
    assert float(f.max()) <= 1.0 and c.dtype == torch.float32
    feats, lab, c = next(s.device_generator(4, 1, augment=True))
    assert feats.shape == (4, PS, PS, 3)
    item = next(iter(s.torch_iterable_dataset()))
    assert item[0].shape == (PS, PS, 3) and item[1].dtype == torch.int64


def test_extract_and_save_subset(synthetic_dataset, tmp_path, monkeypatch):
    ps, per_class = 80, 5  # at 80 px only some classes can host a patch
    drawn = []
    orig = AnnoRegionRndSampler.structs_generator

    def spy(self, *a, **k):
        for batch in orig(self, *a, **k):
            drawn.append(batch)
            yield batch

    monkeypatch.setattr(AnnoRegionRndSampler, "structs_generator", spy)
    test_pairs = get_img_ano_paths(synthetic_dataset, "test")
    out = extract_and_save_subset(test_pairs, tmp_path / "test", ps, LAYER, per_class,
                                  device="cpu")
    sampler = AnnoRegionRndSampler(test_pairs, layer=LAYER, patch_size=ps,
                                   region_intersection=0.95, device="cpu", verbose=False)
    with open_slide(test_pairs[0][0]) as slide:
        layer_img = slide.get_region_from_layer(LAYER, (0, 0), slide.layer_size(LAYER))
    by_class = {}
    for batch in drawn:
        for patch, cls in batch:
            by_class.setdefault(cls, []).append(patch)
    feasible = {c for c in range(len(sampler.classes))
                if (sampler.table.feasible & (sampler.table.class_idx.numpy() == c)).any()}
    assert 0 < len(feasible) < len(sampler.classes)
    for c in range(len(sampler.classes)):
        files = sorted((out / str(c)).glob("*.jpg"), key=lambda f: int(f.stem))
        if c not in feasible:
            assert (out / str(c)).is_dir() and files == []
            continue
        assert [f.stem for f in files] == [str(i) for i in range(per_class)]
        regions = [r.vertices_layer for r in sampler.regions[sampler.classes[c]]]
        for f, patch in zip(files, by_class[c]):
            y, x = patch.pos
            np.testing.assert_array_equal(patch.data, layer_img[y:y + ps, x:x + ps])
            buf = io.BytesIO()
            Image.fromarray(layer_img[y:y + ps, x:x + ps]).save(buf, format="JPEG")
            assert f.read_bytes() == buf.getvalue()
            box = np.array([[x, y, x + ps, y + ps]], np.float64)
            best = max(float(clip_area_boxes(v, box)[0]) for v in regions)
            assert best > 0.95 * ps * ps
