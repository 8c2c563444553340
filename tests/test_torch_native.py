"""The port's native host library (``deephisto_tpu_torch/native``, g++ and
OpenMP, built at the first call) against numpy and the JAX package's own
library, and the callers that dispatch to it. ``g++`` exists wherever these
tests run, so nothing here skips: a library that does not build fails."""

import ctypes

import numpy as np
import pytest
import torch

from deephisto_tpu import native as jax_native
from deephisto_tpu.geometry.polygon import _subdivide_and_clamp
from deephisto_tpu.slide import star_polygon
from deephisto_tpu_torch import native
from deephisto_tpu_torch.geometry import clip_area_boxes, pad_polygons, shoelace_area


def _numpy_clip_areas(poly, boxes):
    return np.array([shoelace_area(_subdivide_and_clamp(poly, *b)) for b in boxes])


def _boxes(rng, n, lo=0, hi=900):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(10, 400, (n, 1))], axis=1)


def test_library_builds_at_first_call_into_the_build_dir():
    assert native.available(), native.build_log
    path = native.library_path()
    assert path.is_file() and path.parent.name == "deephisto_tpu_torch"
    assert native.omp_threads() >= 1


def test_clip_area_boxes_native_matches_numpy_and_the_jax_library():
    rng = np.random.default_rng(0)
    poly = star_polygon(rng, (500, 400), 300, 23)
    boxes = _boxes(rng, 500)
    got = native.clip_area_boxes_native(poly, boxes)
    # the same algorithm, its sums taken in another order than numpy's
    np.testing.assert_allclose(got, _numpy_clip_areas(poly, boxes), rtol=0, atol=1e-6)
    if jax_native.AVAILABLE:  # the same source, built there with -march=native (FMAs)
        np.testing.assert_allclose(got, jax_native.clip_area_boxes_native(poly, boxes),
                                   rtol=0, atol=1e-6)


def test_clip_area_boxes_dispatches_to_the_library():
    rng = np.random.default_rng(1)
    poly = star_polygon(rng, (100, 100), 80, 12)
    boxes = _boxes(rng, 128, 0, 170)
    got = clip_area_boxes(poly, boxes)
    np.testing.assert_array_equal(got, native.clip_area_boxes_native(poly, boxes))
    np.testing.assert_allclose(got, _numpy_clip_areas(poly, boxes), rtol=0, atol=1e-6)
    few = clip_area_boxes(poly, boxes[:10])  # under 64 boxes: numpy
    np.testing.assert_allclose(few, got[:10], rtol=0, atol=1e-6)


def test_polygon_areas_native():
    rng = np.random.default_rng(2)
    polys = [star_polygon(rng, (50, 50), 30, int(rng.integers(4, 20))) for _ in range(10)]
    got = native.polygon_areas_native(pad_polygons(polys, 32).astype(np.float64))
    np.testing.assert_allclose(got, [shoelace_area(p) for p in polys], rtol=1e-5)


def test_extract_patches_native_clamps_as_the_device_gather():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (300, 400, 3), dtype=np.uint8)
    coords = np.array([[0, 0], [100, 200], [300 - 64, 400 - 64], [-5, 390], [299, -7]],
                      dtype=np.int32)
    out = native.extract_patches_native(img, coords, 64)
    want = np.empty_like(out)
    for i, (y, x) in enumerate(coords):
        y, x = min(max(y, 0), 300 - 64), min(max(x, 0), 400 - 64)
        want[i] = img[y:y + 64, x:x + 64]
    np.testing.assert_array_equal(out, want)
    if jax_native.AVAILABLE:
        np.testing.assert_array_equal(out, jax_native.extract_patches_native(img, coords, 64))
    buf = np.empty_like(out)
    assert native.extract_patches_native(img, coords, 64, out=buf) is buf
    np.testing.assert_array_equal(buf, want)


def test_host_bank_gathers_through_the_library(tmp_path):
    from deephisto_tpu_torch.samplers.bank import SlideBank
    from deephisto_tpu_torch.slide.dhs import write_dhs

    rng = np.random.default_rng(4)
    paths = [write_dhs(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8),
                       tmp_path / f"s{i}.dhs", max_layer=2) for i in range(2)]
    dev = SlideBank(paths, layer=1, device="cpu")
    host = SlideBank(paths, layer=1, device="cpu", budget_bytes=0)
    assert not host.on_device
    s = np.array([0, 1, 1, 0], np.int32)
    c = np.array([[3, 5], [100, 90], [-4, 300], [250, 250]], np.int32)
    assert torch.equal(host.gather(s, c, 64), dev.gather(s, c, 64))



@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("rows, row_bytes, stride", [
    (300, 1000, 1000),  # one contiguous block of 300 kB: two pieces of the OpenMP copy
    (300, 1000, 1300),  # rows of a wider array
    (1, 600_003, 0),  # one row, three pieces
    (5, 7, 7),  # fewer bytes than a piece
    (3, 300_000, 300_001),  # strided rows wider than a piece
    (0, 9, 9),
])
def test_stage_upload_native_copies_rows(rows, row_bytes, stride, threads):
    """One chunk through one slot, its copy to the "card" a plain memmove:
    the rows land contiguous, and nothing past them."""
    src = np.random.default_rng(0).integers(0, 256, max(rows * max(stride, row_bytes), 1),
                                            dtype=np.uint8)
    slot = np.zeros(rows * row_bytes + 64, dtype=np.uint8)
    dst = np.zeros(rows * row_bytes + 64, dtype=np.uint8)  # 64 spare bytes stay 0
    htod = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.c_void_p)(lambda d, s, n, stream: ctypes.memmove(d, s, n) and 0)
    record = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)(lambda e, s: 0)
    sync = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(lambda e: 0)
    api = tuple(ctypes.cast(f, ctypes.c_void_p).value for f in (htod, record, sync))
    table = np.array([[0, rows, row_bytes, stride, 0]])
    err = native.stage_upload_native(dst.ctypes.data, src.ctypes.data, table, [slot.ctypes.data],
                                     slot.nbytes, [1], 0, threads, api)
    assert err == 0
    want = [src[r * stride: r * stride + row_bytes] for r in range(rows)]
    np.testing.assert_array_equal(dst[: rows * row_bytes],
                                  np.concatenate(want) if want else dst[:0])
    assert not dst[rows * row_bytes:].any()


def test_stage_upload_native_refuses_a_chunk_larger_than_a_slot():
    buf = np.zeros(64, dtype=np.uint8)
    with pytest.raises(ValueError, match="does not fit a slot"):
        native.stage_upload_native(buf.ctypes.data, buf.ctypes.data, np.array([[0, 4, 20, 20, 0]]),
                                   [buf.ctypes.data], 64, [1], 0, 2, (0, 0, 0))
