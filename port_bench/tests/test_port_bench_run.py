"""Whole runs of each cell on the CPU at tiny sizes (the harness's look for
a card skipped; the program's kernels take their plain versions): a sound
run is correct and its control is not, no JAX module is loaded; then the
timed path broken underneath, and ``correct`` must come out false once for
each fault a cell can have: half of each batch left out, and an answer
altered where it is produced. (A state left unchanged is a training
step's fault, and no cell here exchanges between chips.)"""

import functools
import sys
import time
import types

import numpy as np
import pytest
import torch

from port_bench.core.harness import ROOT, context, load_json, run_cell

SEED = 2**31 + 4242
TINY = {  # cell → its slide sizes here
    "r18q.dense.cohort": [[352, 448], [448, 352]],
    "r18q.fcn.cohort": [[512, 512], [512, 640]],
    "vits8.dense.cohort": [[336, 448], [448, 336]],
}
SECONDS = 2.0


def tiny_ctx(cell: str):
    ctx = context(cell, SEED, "cpu", load_json(ROOT / "BENCHMARK.json"))
    # smaller colour blocks: classes vary in a tiny slide
    ctx.traffic = dict(ctx.traffic, sizes=TINY[cell], block_px=96)
    ctx.checks = dict(ctx.checks, sample_requests=4, cells_per_request=48)
    ctx.cfg = dict(ctx.cfg, engine=dict(ctx.cfg["engine"], tile=256))
    return ctx


@pytest.fixture
def small_batches(monkeypatch):
    """The exact predict at batches of 8 on the CPU (256 padded lanes of a
    plain int8 or f32 forward each slide would take minutes)."""
    from deephisto_tpu_torch.predict import pipeline

    monkeypatch.setattr(pipeline, "predict_full_fused",
                        functools.partial(pipeline.predict_full_fused, batch_size=8))


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_is_correct_and_its_control_is_not(cell, small_batches):
    torch.set_num_threads(4)
    ctx = tiny_ctx(cell)
    result, check, found = run_cell(ctx, SECONDS, False, time.perf_counter(), control=True)
    assert found == []
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(n["value"] <= n["limit"] for n in result["check"].values()), check
    assert any(check["control"][k] > n["limit"] for k, n in result["check"].items()), check
    assert check["control_correct"] is False
    assert list(result)[-1] == "check"
    assert "setup_s" in result["metrics"]


def _broken(cell, fault, monkeypatch):
    """The run of ``cell`` with ``fault`` planted in the program's path."""
    from deephisto_tpu_torch.predict import fcn, pipeline
    from deephisto_tpu_torch.serve import engine

    if fault == "half_batch" and cell == "r18q.fcn.cohort":
        orig = fcn.tile_logits

        def half_tiles(*a, **k):
            out = orig(*a, **k)
            out[out.shape[0] // 2:] = 0  # the step's second half of tiles left out
            return out
        monkeypatch.setattr(fcn, "tile_logits", half_tiles)
    elif fault == "half_batch":
        orig_call = pipeline.BatchPredictor.__call__

        def half(self, score_map, coords, real):
            orig_call(self, score_map, coords, max(1, real // 2))
        monkeypatch.setattr(pipeline.BatchPredictor, "__call__", half)
    else:
        orig_slide = engine.ServingEngine.predict_slide

        def altered(self, *a, **k):
            amap, meta = orig_slide(self, *a, **k)
            return (amap + 1) % self.n_classes, meta
        monkeypatch.setattr(engine.ServingEngine, "predict_slide", altered)


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", list(TINY))
def test_a_broken_path_is_not_correct(cell, fault, small_batches, monkeypatch):
    torch.set_num_threads(4)
    _broken(cell, fault, monkeypatch)
    ctx = tiny_ctx(cell)
    result, check, _ = run_cell(ctx, SECONDS, False, time.perf_counter())
    assert not result["correct"], check


def test_run_prints_no_result_when_the_check_loads_jax(small_batches, monkeypatch, capsys):
    """JAX loaded after the window's look, here by the check, still keeps
    ``run.py`` from printing a result."""
    from port_bench import run
    from port_bench.core import harness
    from port_bench.traffic.kinds import cohort

    cell = "r18q.dense.cohort"
    orig_check = cohort.Kind.check

    def check_loading_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig_check(self, *a, **k)

    real = torch.cuda.is_available, torch.cuda.device_count

    def cpu_ctx(*a, **k):  # the look for a card is passed; the run is on the CPU
        monkeypatch.setattr(torch.cuda, "is_available", real[0])
        monkeypatch.setattr(torch.cuda, "device_count", real[1])
        return tiny_ctx(cell)

    torch.set_num_threads(4)
    monkeypatch.setattr(cohort.Kind, "check", check_loading_jax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "context", cpu_ctx)
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(SECONDS)])
    out, err = capsys.readouterr()
    assert rc == 3, err
    assert out.strip() == "" and "jax" in err.splitlines()[-1]
