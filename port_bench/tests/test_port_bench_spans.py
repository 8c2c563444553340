"""The readers of the program's spans (``core/spans.py`` and the metrics
``engine_wait_share``, ``ingest_gbps``, ``idle_in_host_work_share`` and
``host_syncs_per_slide``) on a run whose device intervals and spans are
written by hand; then a tiny traced run of each ResNet cell on the CPU,
whose result line names the four."""

import importlib
import json
import time

import pytest
import torch
from test_port_bench_run import SEED, small_batches, tiny_ctx  # noqa: F401

from deephisto_tpu_torch import profiling
from deephisto_tpu_torch.profiling import Span
from port_bench.core import spans
from port_bench.core.harness import reader
from port_bench.core.record import Run
from port_bench.core.trace import Trace

T_A, T_B = 10.0, 11.0
NAMES = ("engine_wait_share", "ingest_gbps", "idle_in_host_work_share", "host_syncs_per_slide")
# a tiny request takes a second or more on the CPU, and a request counts only
# if it starts once the profiler runs: 16 s give a 4 s sub-window
TRACED_SECONDS = 16.0


def _request(rid, thread, first_id, t_req, t_serve, t_end, parts):
    """The spans of one request: engine.request from ``t_req``, the lock
    wait up to ``t_serve``, engine.serve to ``t_end``, and under it
    ``parts``: (name, start, end, attrs) in order."""
    sid = iter(range(first_id, first_id + 100))
    req, wait, serve = next(sid), next(sid), next(sid)
    out = [Span("engine.request", t_req, t_end, thread, rid, None, req, {"mode": "dense"}),
           Span("engine.lock_wait", t_req, t_serve, thread, rid, req, wait, {}),
           Span("engine.serve", t_serve, t_end, thread, rid, req, serve, {})]
    ids = {}
    for name, a, b, attrs in parts:
        parent = ids["predict.enqueue"] if name.startswith("xfer") else serve
        ids[name] = next(sid)
        out.append(Span(name, a, b, thread, rid, parent, ids[name], attrs))
    return out


UP = {"pinned": False, "blocking": True}
HAND = (
    # request 1 straddles T_A: 0.4 of its 0.6 s lie in the sub-window
    _request(1, 101, 1, 9.8, 9.9, 10.4, [
        ("ingest.upload", 9.9, 10.1, dict(UP, bytes=2e9)),
        ("predict.prepare", 10.1, 10.15, {"coords": 100}),
        ("predict.enqueue", 10.15, 10.35, {"batches": 1}),
        ("xfer.h2d", 10.2, 10.21, dict(UP, bytes=64)),
        ("predict.readback", 10.35, 10.4, dict(UP, bytes=100)),
    ])
    # request 2 waits for the lock while request 1 is served: 0.9 of 1.05 s inside
    + _request(2, 102, 20, 9.85, 10.4, 10.9, [
        ("ingest.upload", 10.4, 10.6, dict(UP, bytes=1e9)),
        ("predict.prepare", 10.6, 10.65, {"coords": 50}),
        ("predict.enqueue", 10.65, 10.85, {"batches": 1}),
        ("predict.readback", 10.85, 10.9, dict(UP, bytes=100)),
    ])
    # a span of an earlier profiler session, outside the sub-window
    + [Span("ingest.upload", 1.0, 2.0, 101, 0, 7, 99, dict(UP, bytes=5e9))]
)
BUSY = [(10.0, 10.08), (10.12, 10.3), (10.45, 10.7), (10.75, 10.95)]
# the idle gaps: [10.08, 10.12] ingest 1 then prepare 1; [10.3, 10.45] enqueue 1,
# readback 1, then ingest 2; [10.7, 10.75] enqueue 2; [10.95, 11] no request
SPLIT = {"ingest.upload": 0.02 + 0.05, "predict.prepare": 0.02, "predict.enqueue": 0.05 + 0.05,
         "predict.readback": 0.05, spans.NO_REQUEST: 0.05}
SHARE_1, SHARE_2 = 0.4 / 0.6, 0.9 / 1.05


@pytest.fixture
def hand_run(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    tr = Trace(T_A, T_B, device=[(a, b, "kernel", "k") for a, b in BUSY])
    run = Run({}, {}, {}, 0, 1.0)
    run.trace = tr
    return run


def test_the_idle_split_covers_the_idle_time_by_span(hand_run):
    split = spans.idle_split(hand_run)
    assert split == pytest.approx(SPLIT)
    assert 100.0 * sum(split.values()) == pytest.approx(hand_run.trace.idle_share())


def test_each_reader_on_hand_made_spans(hand_run):
    got = {n: reader(n).read(hand_run) for n in NAMES}
    waited = SHARE_1 * 0.1 + SHARE_2 * 0.55
    in_engine = SHARE_1 * 0.6 + SHARE_2 * 1.05
    assert got["engine_wait_share"] == pytest.approx(100.0 * waited / in_engine)
    # request 1's upload: half of 2 GB in 0.1 s inside; request 2's: 1 GB in 0.2 s
    assert got["ingest_gbps"] == pytest.approx((1e9 + 1e9) / 0.3 / 1e9)
    assert got["idle_in_host_work_share"] == pytest.approx(100.0 * (0.02 + 0.1) / 1.0)
    # request 1: upload, index upload, read-back; request 2: upload, read-back
    assert got["host_syncs_per_slide"] == pytest.approx(
        (3 * SHARE_1 + 2 * SHARE_2) / (SHARE_1 + SHARE_2))


def test_without_the_programs_spans_or_a_trace_the_readers_give_nothing(hand_run,
                                                                       monkeypatch):
    untraced = Run({}, {}, {}, 0, 1.0)
    assert all(reader(n).read(untraced) is None for n in NAMES)
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans
    assert all(reader(n).read(hand_run) is None for n in NAMES)


@pytest.mark.parametrize("cell", ["r18q.dense.cohort", "r18q.fcn.cohort"])
def test_a_traced_run_prints_the_four(cell, small_batches, monkeypatch, capsys):  # noqa: F811
    from port_bench import run
    from port_bench.core import harness

    real = torch.cuda.is_available, torch.cuda.device_count

    def cpu_ctx(*a, **k):  # the look for a card is passed; the run is on the CPU
        monkeypatch.setattr(torch.cuda, "is_available", real[0])
        monkeypatch.setattr(torch.cuda, "device_count", real[1])
        return tiny_ctx(cell)

    # the profiler's start imports torch._inductor; under the clients (and a
    # loaded machine) that can push the sub-window past the traffic's end
    importlib.import_module("torch._inductor.config")

    torch.set_num_threads(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "context", cpu_ctx)
    t = time.perf_counter()
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(TRACED_SECONDS),
                   "--trace", "1"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"], err
    assert set(NAMES) <= set(result["metrics"]), result["metrics"]
    assert result["metrics"]["host_syncs_per_slide"]["value"] == 0.0  # the CPU copies nothing
    assert time.perf_counter() - t < 180


def test_the_audit_holds_the_spans_against_the_trace(monkeypatch):
    """``spans_audit.audit`` on the hand-made spans in a wider sub-window
    that holds both requests whole: each blocking span has its copy on the
    card and its synchronize on the host, and each request's first K1
    kernel starts after its ``predict.enqueue`` opens."""
    from port_bench import spans_audit

    monkeypatch.setattr(profiling, "spans", lambda: list(HAND))
    htod, dtoh = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)"
    k1 = "void gather_quantize_int8_kernel<1, 3>(unsigned char const*)"
    blocking = [s for s in HAND if s.attrs.get("blocking") and s.start > 9.5]
    device = [(a, b, "kernel", "k") for a, b in BUSY] + [
        (s.start + 0.001, s.end - 0.002, "gpu_memcpy", dtoh if "readback" in s.name else htod)
        for s in blocking] + [(10.16, 10.17, "kernel", k1), (10.66, 10.67, "kernel", k1)]
    host = [(s.end - 0.001, s.end - 0.0005, "cudaStreamSynchronize") for s in blocking]
    run = Run({}, {}, {}, 0, 1.0)
    run.trace = Trace(9.5, T_B, device=device, host=host)
    out = spans_audit.audit(run)
    assert out["pageable_htod_inside_pct"] == pytest.approx(100.0)
    assert out["k1_after_enqueue"] == {"requests": 1, "after": 1,
                                       "least_lead_ms": pytest.approx(10.0)}
    assert out["syncs"]["requests"] == 2 and out["syncs"]["agree"] == 2
    assert out["syncs"]["stray_calls"] == {}
    assert out["spans_per_request"] == pytest.approx((8 + 7) / 2)
    assert out["idle_split_sum_pct"] == pytest.approx(run.trace.idle_share())
