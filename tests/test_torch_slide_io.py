"""The port's slide previews and layer access against the JAX package's.

``_resize_uint8`` is a port of Pillow's bilinear resize (the port does not
depend on PIL): it must give PIL's bytes exactly
(tolerance 0) for downscales by 16 and by non-integer factors, an upscale,
1-pixel targets, odd sizes and an unchanged axis; ``get_region(target_hw=)``
and ``to_image`` must equal the JAX package's (PIL) output exactly, the
latter returned as an array where the JAX package returns a PIL image."""

import numpy as np
import pytest
from PIL import Image

from deephisto_tpu import slide as jax_slide
from deephisto_tpu_torch import slide as port_slide
from deephisto_tpu_torch.slide.base import _resize_uint8

CASES = [
    ((512, 512), (32, 32)),  # by 16
    ((1024, 768), (64, 48)),  # by 16, not square
    ((300, 200), (224, 224)),  # mixed: down and up
    ((1000, 999), (37, 61)),  # non-integer factors
    ((50, 40), (123, 77)),  # upscale
    ((7, 9), (1, 1)),  # 1-pixel target
    ((33, 17), (1, 5)),
    ((3, 3), (200, 1)),
    ((513, 257), (32, 16)),  # odd sizes
    ((100, 100), (100, 37)),  # one axis unchanged
    ((64, 64), (63, 65)),
]


@pytest.mark.parametrize("src,dst", CASES)
def test_resize_is_pils_bilinear(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    noise = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(src[0]), 3 * np.arange(src[1]))[..., None]
            * np.array([1, 5, 11]) % 256).astype(np.uint8)
    for a in (noise, ramp, np.full(src + (3,), 255, np.uint8)):
        want = np.asarray(Image.fromarray(a).resize((dst[1], dst[0]), Image.BILINEAR))
        got = _resize_uint8(a, dst)
        assert got.dtype == np.uint8 and got.shape == dst + (3,)
        np.testing.assert_array_equal(got, want)


def test_resize_refuses_an_empty_target():
    with pytest.raises(ValueError):
        _resize_uint8(np.zeros((4, 4, 3), np.uint8), (0, 3))


@pytest.fixture(scope="module")
def slides():
    level0 = np.random.default_rng(3).integers(0, 256, (600, 520, 3), dtype=np.uint8)
    return jax_slide.ArraySlide(level0, max_layer=8), port_slide.ArraySlide(level0, max_layer=8)


@pytest.mark.parametrize("tl,br,target", [((0, 0), (600, 520), (37, 32)),
                                          ((10, 20), (310, 420), (300, 400)),
                                          ((5, 5), (105, 55), (240, 120)),
                                          ((0, 0), (600, 520), None)])
def test_get_region_matches_jax(slides, tl, br, target):
    js, ts = slides
    np.testing.assert_array_equal(ts.get_region(tl, br, target_hw=target),
                                  js.get_region(tl, br, target_hw=target))


@pytest.mark.parametrize("kwargs", [{"max_side": 128}, {"max_side": 77}, {"scale": 0.1},
                                    {"scale": 0.5}, {"scale": 2.0},
                                    {"auto_downscale": True, "max_side_limit": 300},
                                    {"auto_downscale": True}, {}])
def test_to_image_matches_jax(slides, kwargs):
    js, ts = slides
    got = ts.to_image(**kwargs)
    want = np.asarray(js.to_image(**kwargs))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_dhs_load_and_mmap_layer_match_jax(tmp_path):
    level0 = np.random.default_rng(5).integers(0, 256, (130, 97, 3), dtype=np.uint8)
    path = port_slide.write_dhs(level0, tmp_path / "s.dhs", max_layer=4)
    with port_slide.DHSlide(path) as ts, jax_slide.DHSlide(path) as js:
        for layer in ts.layers:
            loaded = ts.load_layer(layer)
            assert loaded.flags.c_contiguous and not isinstance(loaded, np.memmap)
            mapped = ts.mmap_layer(layer)
            assert isinstance(mapped, np.memmap)
            np.testing.assert_array_equal(loaded, js.load_layer(layer))
            np.testing.assert_array_equal(mapped, js.mmap_layer(layer))
        with pytest.raises(ValueError):
            ts.load_layer(3)
    # a layer file that disagrees with meta.json is refused
    np.save(path / "L2.npy", np.zeros((10, 10, 3), np.uint8))
    with port_slide.DHSlide(path) as ts, pytest.raises(ValueError, match="meta.json"):
        ts.mmap_layer(2)
    assert port_slide.ArraySlide(level0).mmap_layer(1) is None


def test_psi_without_psimage_raises_as_jax(tmp_path):
    p = tmp_path / "x.psi"
    p.write_bytes(b"")
    with pytest.raises(NotImplementedError) as port_err:
        port_slide.open_slide(p)
    with pytest.raises(NotImplementedError):
        jax_slide.open_slide(p)
    msg = str(port_err.value)
    assert "deephisto_tpu_torch.slide.psi.convert_psi_to_dhs" in msg
    assert "deephisto_tpu.slide" not in msg
    with pytest.raises(ValueError, match="unknown slide format"):
        port_slide.open_slide(tmp_path / "x.tiff")


@pytest.mark.parametrize("shape", [(257, 129, 3), (64, 64, 3), (1, 3, 3), (100, 77, 3)])
def test_build_pyramid_matches_jax(shape):
    """The port sums each 2x2 block from strided views; the values are the
    JAX package's reshape-and-sum, edge padding of odd sizes included."""
    a = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    want, got = jax_slide.build_pyramid(a, 8), port_slide.build_pyramid(a, 8)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
