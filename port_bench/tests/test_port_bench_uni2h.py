"""``uni2h.dense.cohort`` run whole on the CPU at a tiny size, as
``test_port_bench_run.py`` runs the other cells: the configuration's model
cut to dim 256 (4 heads of 64, gated width 512) at its 24 blocks, 8
registers and 265 tokens a patch (the published 1536 wide model takes
minutes a patch on the CPU), its weights drawn as the family draws them,
two tiny slides; the kernels take their plain versions. A sound run is
correct and its float8 control is not; half of each batch left out, or an
answer altered, comes out not correct. The tiny model keeps all 24 blocks:
the float8 control's gap grows with the depth."""

import functools
import time

import pytest
import torch

from port_bench.core.harness import ROOT, context, load_json, run_cell

CELL = "uni2h.dense.cohort"
SEED = 2**31 + 4242
NARROW = dict(dim=256, heads=4, mlp_hidden=512)
SECONDS = 2.0


def tiny_ctx():
    ctx = context(CELL, SEED, "cpu", load_json(ROOT / "BENCHMARK.json"))
    ctx.traffic = dict(ctx.traffic, sizes=[[336, 448], [448, 336]], block_px=96)
    ctx.checks = dict(ctx.checks, sample_requests=4, cells_per_request=48)
    ctx.cfg = dict(ctx.cfg, **NARROW)
    return ctx


@pytest.fixture
def small_batches(monkeypatch):
    from deephisto_tpu_torch.predict import pipeline

    monkeypatch.setattr(pipeline, "predict_full_fused",
                        functools.partial(pipeline.predict_full_fused, batch_size=8))


def test_the_tiny_model_keeps_the_configurations_depth_and_tokens():
    ctx = tiny_ctx()
    with torch.device("meta"):
        model = ctx.family.program_model(ctx.cfg)
    assert model.depth == 24 and model.n_tokens == ctx.cfg["tokens"] == 265


def test_sound_run_is_correct_and_its_control_is_not(small_batches):
    torch.set_num_threads(4)
    ctx = tiny_ctx()
    result, check, found = run_cell(ctx, SECONDS, False, time.perf_counter(), control=True)
    assert found == []
    assert result["correct"], check
    assert result["attempted"] > 0 and result["failed"] == 0
    assert any(check["control"][k] > n["limit"] for k, n in result["check"].items()), check
    assert check["control_correct"] is False
    assert set(result["metrics"]) == {"patches_per_s.vit", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_path_is_not_correct(fault, small_batches, monkeypatch):
    from deephisto_tpu_torch.predict import pipeline
    from deephisto_tpu_torch.serve import engine

    if fault == "half_batch":
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
    torch.set_num_threads(4)
    result, check, _ = run_cell(tiny_ctx(), SECONDS, False, time.perf_counter())
    assert not result["correct"], check


def test_the_counts_at_the_published_sizes():
    """370.94 GFLOP a patch (65 % of it the gated MLP, 2.8 % attention);
    K7's byte bound 0.497 ms a block of 256 patches; K3's bound by bytes at
    N = 265."""
    from port_bench.core.flops import HBM_BYTES_PER_S
    from port_bench.families import vit_reg

    cfg = load_json(ROOT / "port_bench" / "configs" / "uni2h_bf16.json")
    assert vit_reg.tokens(cfg) == 265
    assert vit_reg.patch_ops(cfg) == 370_940_461_056
    n, d, h = 265, 1536, 4096
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + n * d * 2 * h + n * h * d
    assert (n * d * 2 * h + n * h * d) / block == pytest.approx(0.648, abs=1e-3)
    assert 2 * n * n * d / block == pytest.approx(0.028, abs=1e-3)
    assert vit_reg.glu_bound_s(cfg, 256) / 24 * 1e3 == pytest.approx(0.4977, abs=1e-4)
    assert vit_reg.k3_bound_s(cfg, 256) == pytest.approx(
        24 * 4.0 * 256 * n * d * 2 / HBM_BYTES_PER_S)
    counts = vit_reg.request_counts(cfg, "dense", 2352, 4544)
    assert set(counts) == {"work_ops", "k3_bound_s", "glu_bound_s"}
    with pytest.raises(ValueError):
        vit_reg.request_counts(cfg, "fcn", 2352, 4544)


def test_glu_roofline_reads_k7_and_nothing_without_it():
    from port_bench.core.harness import reader
    from port_bench.core.record import Run
    from port_bench.core.trace import Trace

    reqs = [{"ok": True, "t_submit": 0.0, "t_done": 10.0, "n_equiv": 1000, "work_ops": 1.0,
             "glu_bound_s": 0.6, "k3_bound_s": 0.1}]
    tr = Trace(2.5, 7.5)
    tr.device = [(3.0, 3.2, "kernel", "void (anonymous namespace)::swiglu_kernel<__nv_bfloat16>"
                  "(uint4 const*, uint4*, int, int)"), (4.0, 4.1, "kernel", "nvjet_gemm")]
    run = Run({"name": CELL}, {"precision": "bfloat16"}, {}, 0, 10.0, requests=reqs, trace=tr)
    assert reader("glu_roofline").read(run) == pytest.approx(100 * 0.3 / 0.2)
    tr.device = tr.device[1:]  # the parent's program: no K7
    assert reader("glu_roofline").read(run) is None
    run.trace = None
    assert reader("glu_roofline").read(run) is None
