"""The slide ingest's staging ring (``predict/ingest.py``): its chunk plan,
its copy loop on plain CPU slots, and, on a card, the direct paths and an
upload that queues behind a kernel still running on the stream. This file
imports no JAX, so it also runs on the machine with the card:
``python -m pytest -m gpu tests/test_torch_ingest.py``. The ``gpu`` tests
decide in their body whether a card is present and skip without one."""

import ctypes
import math

import numpy as np
import pytest
import torch

from deephisto_tpu_torch import native
from deephisto_tpu_torch.predict import ingest
from deephisto_tpu_torch.predict.ingest import _Ring, chunk_plan, chunk_table, upload_slide
from deephisto_tpu_torch.profiling import spans


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _slide(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _upload_span(fn):
    """``fn()``'s result and the one ``ingest.upload`` span it recorded."""
    last = max((s.id for s in spans()), default=0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    (got,) = [s for s in spans() if s.id > last and s.name == "ingest.upload"]
    return out, got


@pytest.mark.parametrize("shape, slot, itemsize, want", [
    # rows that do not divide a slot: 2 rows of 12 bytes a chunk, the last takes the remainder
    ((5, 4, 3), 25, 1, [((), 0, 2), ((), 2, 4), ((), 4, 5)]),
    # exact multiples
    ((4, 2, 3), 12, 1, [((), 0, 2), ((), 2, 4)]),
    ((6, 4), 16, 4, [((), 0, 1), ((), 1, 2), ((), 2, 3), ((), 3, 4), ((), 4, 5), ((), 5, 6)]),
    # a row wider than a slot is cut within the row, 2 pixels a chunk
    ((2, 5, 3), 7, 1, [((0,), 0, 2), ((0,), 2, 4), ((0,), 4, 5),
                       ((1,), 0, 2), ((1,), 2, 4), ((1,), 4, 5)]),
    # a pixel wider than a slot is cut within the pixel
    ((1, 2, 3), 2, 1, [((0, 0), 0, 2), ((0, 0), 2, 3), ((0, 1), 0, 2), ((0, 1), 2, 3)]),
    # a one-row slide, in one chunk and cut within
    ((1, 3, 3), 9, 1, [((), 0, 1)]),
    ((1, 3, 3), 1 << 20, 1, [((), 0, 1)]),
    ((1, 5, 3), 6, 1, [((0,), 0, 2), ((0,), 2, 4), ((0,), 4, 5)]),
    # a slide that fits a slot takes one chunk; nothing to copy takes none
    ((40, 30, 3), 1 << 20, 1, [((), 0, 40)]),
    ((0, 30, 3), 1 << 20, 1, []),
])
def test_chunk_plan(shape, slot, itemsize, want):
    plan = chunk_plan(shape, slot, itemsize)
    assert plan == want
    # the chunks tile the array in order, each within a slot
    x = np.arange(math.prod(shape)).reshape(shape)
    blocks = [x[prefix][a:b] for prefix, a, b in plan]
    assert all(0 < blk.size * itemsize <= slot for blk in blocks)
    flat = np.concatenate([blk.ravel() for blk in blocks]) if blocks else np.empty(0, int)
    np.testing.assert_array_equal(flat, x.ravel())


def test_chunk_plan_refuses_a_slot_smaller_than_an_element():
    with pytest.raises(ValueError, match="holds no element"):
        chunk_plan((4, 4), 2, itemsize=4)


BIG = _slide(300, 220)


class FakeStream:
    """Stand-ins for libcuda's copy, record and synchronize, for
    the native loop on the CPU. A copy is only queued; it runs when a wait
    on a later event of the stream covers it, as the card would run it
    later. A slot refilled before its copy ran, or a return before the last
    copy ran, shows in the result."""

    def __init__(self, fail_at: int | None = None):
        self.queue, self.log, self.fail_at = [], [], fail_at
        htod = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_void_p)
        record = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
        sync = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
        self._fns = (htod(self.htod), record(self.record), sync(self.sync))  # kept alive
        self.api = tuple(ctypes.cast(f, ctypes.c_void_p).value for f in self._fns)

    def htod(self, dst, src, n, stream):
        if self.log.count("copy") == self.fail_at:
            return 700
        self.queue.append(("copy", dst, src, n))
        self.log.append("copy")
        return 0

    def record(self, event, stream):
        self.queue.append(("event", event))
        self.log.append(f"record {event}")
        return 0

    def sync(self, event):
        self.log.append(f"sync {event}")
        done = [i for i, q in enumerate(self.queue) if q == ("event", event)]
        for q in self.queue[: done[-1] + 1 if done else 0]:
            if q[0] == "copy":
                ctypes.memmove(q[1], q[2], q[3])
        del self.queue[: done[-1] + 1 if done else 0]
        return 0


SOURCES = {
    "contiguous": BIG,
    "row-strided view": BIG[17:281, 9:200],  # a crop: rows of a larger array
    "float32": BIG[:40].astype(np.float32) / 7,
    "1-d": BIG[5, 3:203, 1],  # strided inside its one row
}


@pytest.mark.parametrize("slots, slot_bytes", [(2, 1000), (3, 5000), (4, 1 << 20), (2, 500),
                                               (2, 331)])  # 331: runs inside the rows
@pytest.mark.parametrize("source", ["contiguous", "row-strided view", "float32"])
def test_ring_on_cpu_slots_is_bit_equal(slots, slot_bytes, source):
    """The native loop with plain slots and a stream that runs each copy
    late: the result equals the source, every copy ran, and each slot was
    refilled only after a wait on its event."""
    src = SOURCES[source]
    t = torch.as_tensor(src)
    dst = torch.zeros(t.shape, dtype=t.dtype)
    fake = FakeStream()
    ring = _Ring(torch.device("cpu"), slots, slot_bytes, api=fake.api)
    n = ring.copy(t, dst)
    want = chunk_plan(tuple(t.shape), slot_bytes, t.element_size())
    assert n == len(want) >= 1 and fake.queue == []
    np.testing.assert_array_equal(dst.numpy(), src)
    copies = [i for i, op in enumerate(fake.log) if op == "copy"]
    for c in range(slots, n):  # the wait for the slot's previous copy comes before its refill
        assert f"sync {c % slots + 1}" in fake.log[copies[c - 1]:copies[c]]
    assert fake.log[-1] == f"sync {(n - 1) % slots + 1}"
    assert all(b.numel() == slot_bytes and not b.is_pinned() for b in ring.bufs)


def test_ring_reports_the_first_error_after_waiting_for_the_copies_issued():
    t = torch.as_tensor(BIG)
    dst = torch.zeros_like(t)
    fake = FakeStream(fail_at=3)
    ring = _Ring(torch.device("cpu"), 2, 20_000, api=fake.api)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ring.copy(t, dst)
    assert fake.log.count("copy") == 3 and fake.queue == [] and fake.log[-1] == "sync 1"
    rows = 20_000 // (220 * 3)
    np.testing.assert_array_equal(dst.numpy()[: 3 * rows], BIG[: 3 * rows])


@pytest.mark.parametrize("shape, strides, itemsize, slot, want", [
    # whole rows of a crop: source rows 100 elements apart
    ((5, 4, 3), (300, 3, 1), 1, 25, [(0, 2, 12, 300, 0), (600, 2, 12, 300, 24),
                                     (1200, 1, 12, 300, 48)]),
    # a row wider than a slot: runs inside each row
    ((2, 5, 3), (30, 3, 1), 2, 14, [(0, 1, 12, 12, 0), (12, 1, 12, 12, 12), (24, 1, 6, 6, 24),
                                    (60, 1, 12, 12, 30), (72, 1, 12, 12, 42),
                                    (84, 1, 6, 6, 54)]),
    ((7,), (1,), 4, 12, [(0, 1, 12, 12, 0), (12, 1, 12, 12, 12), (24, 1, 4, 4, 24)]),
])
def test_chunk_table(shape, strides, itemsize, slot, want):
    got = chunk_table(shape, strides, itemsize, slot)
    assert got.dtype == np.int64 and got.tolist() == [list(w) for w in want]


@pytest.mark.parametrize("source, stageable", [
    ("contiguous", True), ("row-strided view", True), ("float32", True), ("1-d", False),
    ("transposed", False), ("empty", False),
])
def test_which_sources_the_ring_takes(source, stageable):
    """Rows contiguous inside go through the ring; any other source, as
    any upload to the CPU, goes direct and comes out equal."""
    src = {**SOURCES, "transposed": BIG.transpose(1, 0, 2), "empty": BIG[:0]}[source]
    t = torch.as_tensor(src)
    assert ingest._rows_contiguous(t) == stageable
    out, up = _upload_span(lambda: upload_slide(src, "cpu"))
    np.testing.assert_array_equal(out.numpy(), src)
    assert up.attrs["staged"] == 0


def test_upload_to_the_cpu_is_direct_and_stages_nothing():
    out, up = _upload_span(lambda: upload_slide(BIG, "cpu"))
    np.testing.assert_array_equal(out.numpy(), BIG)
    assert up.attrs == {"bytes": BIG.nbytes, "pinned": False, "blocking": False, "staged": 0}
    assert ingest._staging_ring(torch.as_tensor(BIG), torch.device("cpu")) is None


# --------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_pageable_upload_goes_through_the_ring():
    _need_card()
    w = 4100
    src = _slide((ingest.SLOTS + 1) * ingest.SLOT_BYTES // (3 * w) + 5, w)
    assert len(chunk_plan(src.shape, ingest.SLOT_BYTES)) > ingest.SLOTS
    for image in (src, src[50:2850, 100:]):  # and a row-strided view
        out, up = _upload_span(lambda: upload_slide(image, "cuda"))
        assert out.is_cuda and out.is_contiguous()
        assert up.attrs["staged"] == len(chunk_plan(image.shape, ingest.SLOT_BYTES)) >= 1
        assert up.attrs["bytes"] == image.nbytes and up.attrs["blocking"]
        assert not up.attrs["pinned"]
        np.testing.assert_array_equal(out.cpu().numpy(), image)
    # one ring for the card, its pinned size fixed whatever the slide's
    (ring,) = [r for d, r in ingest._rings.items() if d.type == "cuda"]
    assert len(ring.bufs) == ingest.SLOTS
    assert all(b.numel() == ingest.SLOT_BYTES and b.is_pinned() for b in ring.bufs)


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["pinned", "on the card"])
def test_pinned_and_device_sources_go_direct(source):
    _need_card()
    host = torch.from_numpy(_slide(700, 900))
    t = host.pin_memory() if source == "pinned" else host.cuda()
    out, up = _upload_span(lambda: upload_slide(t, "cuda"))
    assert up.attrs["staged"] == 0 and up.attrs["pinned"] == (source == "pinned")
    assert out.is_cuda
    assert torch.equal(out.cpu(), host)


@pytest.mark.gpu
def test_upload_queued_behind_a_running_kernel_waits_for_its_slots():
    """A kernel still runs on the stream, so every chunk's copy to the card
    waits behind it: the host may fill a slot again only once the slot's
    previous copy has run, and the upload returns only once the last has.
    Slots refilled early, or zeroed after the return, would show in the
    result."""
    _need_card()
    src = torch.from_numpy(_slide(1000, 1400))  # 4.2 MB: 17 chunks through 2 slots
    ring = _Ring(torch.device("cuda", torch.cuda.current_device()), 2, 1 << 18)
    dst = torch.empty(src.shape, dtype=src.dtype, device="cuda")
    for _ in range(3):
        dst.zero_()
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream
        n = ring.copy(src, dst)
        for b in ring.bufs:
            b.zero_()
        assert n == len(chunk_plan(tuple(src.shape), 1 << 18)) == 17
        assert torch.equal(dst.cpu(), src)
