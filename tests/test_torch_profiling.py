"""The port's tracing and profiling utilities, read as the JAX package's
tests read its own (tests/test_profiling.py): ``StageTimer``'s report, and a
trace that names the annotated region (here a Chrome/Perfetto JSON); then
the program's own spans on a CPU int8 engine's dense and fcn predicts."""

import ctypes
import functools
import json
import threading

import numpy as np
import pytest
import torch

from deephisto_tpu_torch.models.resnet import BasicBlock, ResNet
from deephisto_tpu_torch.predict import ingest, pipeline
from deephisto_tpu_torch.predict.fcn import _grid, tile_steps
from deephisto_tpu_torch.profiling import (
    MARKS,
    TRACE_FILE,
    TRACE_MARK,
    StageTimer,
    annotate,
    spans,
    trace,
)
from deephisto_tpu_torch.serve import ServingEngine


def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    for _ in range(3):
        with t.stage("work", items=10):
            sum(range(1000))
    with t.stage("other"):
        pass
    rep = t.report()
    assert "work" in rep and "items/s" in rep and "3 calls" in rep
    assert t.items["work"] == 30
    assert rep.splitlines()[0].startswith("work")  # longest stage first


def test_stage_timer_sync_takes_a_tensor_or_a_structure():
    t = StageTimer()
    x = torch.ones(8, 8)
    with t.stage("mm", items=8, sync={"out": (x @ x,)}):
        pass
    with t.stage("none", sync=[]):
        pass
    assert t.counts["mm"] == 1 and t.totals["mm"] > 0


def test_trace_writes_a_json_trace_naming_the_region(tmp_path):
    with trace(str(tmp_path)):
        with annotate("region"):
            x = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(x[0, 0]) == 64.0
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "region" in names
    assert any("mm" in (n or "") for n in names)


# --------------------------------------------------------------------------
# the program's spans, on a CPU int8 engine (the cells' dense and fcn paths)

PS, NC, H, W = 64, 5, 160, 130
FCN = dict(tile=64, halo=32, tile_batch=2)
DENSE_BATCH = 2
SPANS = {  # every span of a request, with the span it opens under
    "engine.request": None,
    "engine.lock_wait": "engine.request",
    "engine.serve": "engine.request",
    "ingest.upload": "engine.serve",
    "predict.prepare": "engine.serve",
    "predict.enqueue": "engine.serve",
    "predict.readback": "engine.serve",
}
FCN_SPANS = dict(SPANS, **{"xfer.h2d": "predict.enqueue"})  # the int8 scan's index uploads


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    m = ResNet((1, 1, 1, 1), BasicBlock, NC, num_filters=8, dtype=torch.float32, stem="s2d")
    calib = np.random.default_rng(0).integers(0, 255, (8, PS, PS, 3), dtype=np.uint8)
    cfg = {"model": {"n_classes": NC, "depth": 18, "stem": "s2d"},
           "dataset": {"patch_size": PS}}
    eng = ServingEngine(m, cfg, int8=True, calib=calib, device="cpu", **FCN)
    yield eng
    eng.close()


@pytest.fixture
def slide(monkeypatch):
    """A slide, with the exact predict at batches of DENSE_BATCH (its 4
    patches then take 2 batches)."""
    monkeypatch.setattr(pipeline, "predict_full_fused",
                        functools.partial(pipeline.predict_full_fused, batch_size=DENSE_BATCH))
    return np.random.default_rng(1).integers(0, 255, (H, W, 3), dtype=np.uint8)


def _new_spans(last_id: int):
    return [s for s in spans() if s.id > last_id]


def _last_id() -> int:
    return max((s.id for s in spans()), default=0)


@pytest.mark.parametrize("mode", ["dense", "fcn"])
def test_no_span_is_recorded_without_a_profiler(engine, slide, mode):
    last = _last_id()
    engine.predict_slide(slide, mode=mode)
    assert _new_spans(last) == []


@pytest.mark.parametrize("mode", ["dense", "fcn"])
def test_a_thread_started_before_the_profiler_records_every_span(engine, slide, mode):
    """The engine's client threads run before the profiler starts, and
    ``record_function`` there records nothing: the spans switch on from the
    process-wide flag ``torch.autograd.profiler._is_profiler_enabled``."""
    go, last = threading.Event(), _last_id()
    worker = threading.Thread(target=lambda: (go.wait(30), engine.predict_slide(slide, mode=mode)))
    worker.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        go.set()
        worker.join(timeout=60)
    assert not worker.is_alive()
    got = _new_spans(last)
    want = FCN_SPANS if mode == "fcn" else SPANS
    assert sorted({s.name for s in got}) == sorted(want)
    by_id = {s.id: s for s in got}
    (request,) = [s for s in got if s.name == "engine.request"]
    assert request.attrs == {"mode": mode, "h": H, "w": W}
    for s in got:
        assert s.request == request.request and s.thread == request.thread
        assert s.start <= s.end
        if want[s.name] is None:
            assert s.parent is None
        else:
            parent = by_id[s.parent]
            assert parent.name == want[s.name]
            assert parent.start <= s.start and s.end <= parent.end
    (upload,) = [s for s in got if s.name == "ingest.upload"]
    assert upload.attrs == {"bytes": H * W * 3, "pinned": False, "blocking": False, "staged": 0}
    (enqueue,) = [s for s in got if s.name == "predict.enqueue"]
    if mode == "dense":
        n = len(pipeline.dense_coords(H, W, PS, 112))
        assert enqueue.attrs["batches"] == -(-n // DENSE_BATCH) == 2
    else:
        ty, tx, _, _ = _grid(H, W, FCN["tile"], FCN["halo"])
        assert enqueue.attrs["batches"] == tile_steps(ty * tx, FCN["tile_batch"])[1] == 5
        idx = [s for s in got if s.name == "xfer.h2d"]
        assert [s.attrs["bytes"] for s in idx] == [4 * 5 * 2, 4 * 5 * 2 * 2]  # sidx, origin
    (readback,) = [s for s in got if s.name == "predict.readback"]
    assert readback.attrs["bytes"] == (H // 16) * (W // 16)


@pytest.mark.parametrize("mode", ["dense", "fcn"])
def test_the_staging_ring_serves_the_same_map_and_counts_its_chunks(engine, slide, mode,
                                                                     monkeypatch):
    """The ring's copy loop on plain CPU slots (the card's path, where a
    pageable slide goes to a card): the request's ``ingest.upload`` span
    counts the chunks, and the map is the direct path's."""
    want, _ = engine.predict_slide(slide, mode=mode)
    # libcuda's copy, record and wait, stood in for on the CPU
    htod = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.c_void_p)(lambda d, s, n, stream: ctypes.memmove(d, s, n) and 0)
    record = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)(lambda e, s: 0)
    sync = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)(lambda e: 0)
    api = tuple(ctypes.cast(f, ctypes.c_void_p).value for f in (htod, record, sync))
    slot = 4096  # 10 rows of 390 bytes a chunk
    monkeypatch.setattr(ingest, "_staging_ring",
                        lambda t, device: ingest._Ring(device, 2, slot, api=api))
    last = _last_id()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got, _ = engine.predict_slide(slide, mode=mode)
    (upload,) = [s for s in _new_spans(last) if s.name == "ingest.upload"]
    assert upload.attrs["staged"] == len(ingest.chunk_plan((H, W, 3), slot)) == 16
    assert upload.attrs["bytes"] == H * W * 3
    np.testing.assert_array_equal(got, want)


def test_trace_writes_the_program_spans_in_the_profilers_window(engine, slide, tmp_path):
    with trace(str(tmp_path)):
        amap, _ = engine.predict_slide(slide, mode="dense")
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    program = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(program) == sorted(SPANS)
    assert program["engine.request"]["args"]["mode"] == "dense"
    serve = program["engine.serve"]
    marks = [e for e in events if e.get("name") == TRACE_MARK]
    assert len(marks) == 2 * MARKS
    assert sorted(m["ts"] for m in marks)[MARKS - 1] <= program["engine.request"]["ts"]
    # the profiler's own record of the read-back's argmax lies inside the
    # engine.serve span, once the spans are moved to the trace's clock
    (argmax,) = [e for e in events if e.get("name") == "aten::argmax"]
    assert serve["ts"] <= argmax["ts"]
    assert argmax["ts"] + argmax["dur"] <= serve["ts"] + serve["dur"]
    assert amap.shape == (H // 16, W // 16)
