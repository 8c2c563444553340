"""The port's tracing and profiling utilities, read as the JAX package's
tests read its own (tests/test_profiling.py): ``StageTimer``'s report, and a
trace that names the annotated region (here a Chrome/Perfetto JSON)."""

import json

import torch

from deephisto_tpu_torch.profiling import TRACE_FILE, StageTimer, annotate, trace


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
