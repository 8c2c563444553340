"""The benchmark's yardstick on the CPU: traffic generators, patch counts,
operation counts against hand counts, and the metric readers on small
synthetic records and traces."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.core import flops
from port_bench.core.record import Run, p95, prorated, service_intervals
from port_bench.core.trace import MARK, Trace, reduce_events
from port_bench.core.harness import metrics_for, reader
from port_bench.reference.maps import dense_coords
from port_bench.traffic.kinds import slides

BENCH = Path(__file__).resolve().parents[1]
R18 = json.loads((BENCH / "configs" / "resnet18_s2d_int8.json").read_text())
VIT = json.loads((BENCH / "configs" / "vit_s8_bf16.json").read_text())
SEEDS = (0, 7, 2**31 + 12345)


# ---------------------------------------------------------------------------
# traffic


@pytest.mark.parametrize("seed", SEEDS)
def test_cohort_order_repeats_and_keeps_the_multiset(seed):
    a, b = slides.order(seed, 16, 200), slides.order(seed, 16, 200)
    assert np.array_equal(a, b)
    for c in range(0, 192, 16):  # every cycle sends every size once
        assert sorted(a[c:c + 16].tolist()) == list(range(16))


def test_cohort_order_differs_between_seeds():
    assert not np.array_equal(slides.order(1, 16, 64), slides.order(2, 16, 64))


def test_request_blocks_are_distinct_and_repeat():
    blocks = [slides.request_block(5, i, 600, 700, 224) for i in range(50)]
    again = slides.request_block(5, 17, 600, 700, 224)
    assert blocks[17][:2] == again[:2] and np.array_equal(blocks[17][2], again[2])
    keys = {(y, x, b.tobytes()) for y, x, b in blocks}
    assert len(keys) == 50
    assert all(0 <= y <= 600 - 224 and 0 <= x <= 700 - 224 for y, x, _ in blocks)


def test_slides_repeat_from_the_seed():
    a = slides.make_slide(3, 1, 300, 520, 128, "cpu")
    assert torch.equal(a, slides.make_slide(3, 1, 300, 520, 128, "cpu"))
    assert not torch.equal(a, slides.make_slide(4, 1, 300, 520, 128, "cpu"))
    assert a.shape == (300, 520, 3) and a.dtype == torch.uint8 and int(a.max()) <= 254


def test_request_slide_carries_its_block():
    t = {"block_px": 128, "request_block": 224}
    rec = {"i": 9, "size": 2, "h": 400, "w": 500}
    s = slides.request_slide(11, rec, t, "cpu")
    y, x, blk = slides.request_block(11, 9, 400, 500, 224)
    assert np.array_equal(s[y:y + 224, x:x + 224].numpy(), blk)


# ---------------------------------------------------------------------------
# counts


@pytest.mark.parametrize("h,w", [(224, 224), (2048, 2048), (16384, 16384), (2080, 2976),
                                 (13872, 11152)])
def test_dense_coords_counts(h, w):
    c = dense_coords(h, w)
    ny = len(range(0, h - 224, 112)) + 1
    nx = len(range(0, w - 224, 112)) + 1
    assert len(c) == ny * nx == flops.equivalent_patches(h, w)
    assert c[:, 0].max() == h - 224 and c[:, 1].max() == w - 224
    assert len({tuple(p) for p in c.tolist()}) == len(c)


def test_dense_coords_16384():
    assert len(dense_coords(16384, 16384)) == 146 ** 2


def test_resnet18_s2d_ops_by_hand():
    # MACs: stem 56²·64·(2·2·48); layer1 4 × 56²·64·576; layers 2-4 each
    # 2 × 3×3 convs at the stage's width plus its stride-2 entry conv and
    # 1×1 downsample: (57.8 + 115.6 + 6.4 + 231.2) M
    macs = 3136 * 64 * 192 + 4 * 3136 * 64 * 576 + 3 * (57_802_752 + 115_605_504
                                                       + 6_422_528 + 231_211_008)
    assert flops.resnet_patch_ops(R18) == 2 * macs
    assert abs(flops.resnet_patch_ops(R18) / 1e9 - 3.47) < 0.005
    convs = flops.resnet_convs(R18, 224, 224)
    assert len(convs) == 20  # K6's launches a batch
    assert [c["mode"] for c in convs].count("block") == 9


def test_vit_s8_ops_by_hand():
    n, d, m = 784, 384, 1536
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * m
    assert flops.vit_patch_ops(VIT) == 2 * (n * d * 192 + 12 * block)
    assert abs(flops.vit_patch_ops(VIT) / 1e9 - 44.74) < 0.01


def test_conv_bound_takes_the_larger_bound():
    c = flops.resnet_convs(R18, 224, 224)[1]  # layer1's first 3x3 conv, int8 out
    ops, nbytes = flops.conv_ops(c, 256), flops.conv_bytes(c, 256)
    assert flops.conv_bound_s(c, 256, "int8") == max(ops / 1979e12, nbytes / 3.35e12)
    assert nbytes == 256 * 56 * 56 * 64 * 2 + 64 * 576 + 8 * 64 + 8


def test_attention_bound():
    s = flops.attention_bound_s(VIT, 10)
    assert s == pytest.approx(12 * 4.0 * 10 * 784**2 * 384 / 989e12)


# ---------------------------------------------------------------------------
# readers


def _run(requests, trace=None, precision="int8"):
    r = Run({"name": "c"}, {"precision": precision}, {}, 0, 10.0, setup_s=12.5, t0=0.0,
            t1=10.0, requests=requests, trace=trace)
    return r


def _slide_requests():
    # four slides back to back, 2.5 s each; the card serialized
    return [{"ok": True, "t_submit": 0.0 if i < 2 else 2.5 * (i - 1), "t_done": 2.5 * (i + 1),
             "n_equiv": 1000, "work_ops": 4e15, "k6_bound_s": 0.5, "k3_bound_s": 0.25}
            for i in range(4)]


def _trace():
    tr = Trace(2.5, 7.5)
    tr.device = [(2.5, 3.5, "kernel", "void conv_int8_wgmma<1>(Conv)"),
                 (3.0, 4.0, "kernel", "flash_fwd_tma"),
                 (4.0, 4.5, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)"),
                 (5.0, 6.0, "kernel", "other_kernel")]
    tr.host = [(4.6, 4.9, "aten::copy_"), (4.5, 5.0, "aten::to")]
    tr.spans = [(2.5, 7.5, "engine.predict_slide dense")]
    return tr


def test_service_intervals_and_proration():
    req = _slide_requests()
    iv = service_intervals(req)
    assert [(a, b) for a, b, _ in iv] == [(0.0, 2.5), (2.5, 5.0), (5.0, 7.5), (7.5, 10.0)]
    assert prorated(req, "work_ops", 2.5, 7.5) == pytest.approx(8e15)
    assert prorated(req, "work_ops", 1.25, 3.75) == pytest.approx(4e15)


def test_p95_nearest_rank():
    assert p95(range(1, 101)) == 95
    assert p95([3.0]) == 3.0


def test_end_to_end_readers():
    run = _run(_slide_requests())
    assert reader("patches_per_s").read(run) == pytest.approx(400.0)
    assert reader("slide_p95_s").read(run) == pytest.approx(5.0)
    assert reader("setup_s").read(run) == 12.5


def test_per_layer_readers():
    run = _run(_slide_requests(), _trace())
    assert reader("mfu").read(run) == pytest.approx(100 * 8e15 / 5.0 / 1979e12)
    assert reader("k6_roofline").read(run) == pytest.approx(100 * 1.0 / 1.0)
    assert reader("k3_roofline").read(run) == pytest.approx(100 * 0.5 / 1.0)
    assert reader("upload_share").read(run) == pytest.approx(100 * 0.5 / 5.0)
    busy = 2.0 + 1.0  # [2.5, 4.5] and [5, 6]
    assert reader("device_idle_share").read(run) == pytest.approx(100 * (1 - busy / 5.0))


@pytest.mark.parametrize("name", ["mfu.vit", "upload_share.vit", "device_idle_share.vit",
                                  "patches_per_s.vit"])
def test_a_split_metric_takes_its_base_names_reader(name):
    run = _run(_slide_requests(), _trace())
    assert reader(name).read(run) == pytest.approx(reader(name.split(".", 1)[0]).read(run))


def test_a_reader_of_the_full_name_comes_first(tmp_path, monkeypatch):
    from port_bench.core import harness

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "m.py").write_text("def read(run):\n    return 1.0\n")
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    assert harness.reader("m.x").read(None) == 1.0
    (tmp_path / "metrics" / "m.x.py").write_text("def read(run):\n    return 2.0\n")
    assert harness.reader("m.x").read(None) == 2.0
    with pytest.raises(FileNotFoundError):
        harness.reader("n.x")


def test_readers_find_nothing_without_a_trace():
    run = _run(_slide_requests())
    for name in ("mfu", "k6_roofline", "k3_roofline", "upload_share", "device_idle_share"):
        assert reader(name).read(run) is None
    tr = Trace(0.0, 1.0)  # a trace with no K6 kernel: no roofline, never 0
    run.trace = tr
    assert reader("k6_roofline").read(run) is None


def test_breakdown_names_gaps_by_the_host():
    b = _trace().breakdown()
    assert {n for n, _ in b["device_ops"]} == {
        "void conv_int8_wgmma<1>(Conv)", "flash_fwd_tma", "other_kernel",
        "Memcpy HtoD (Pageable -> Device)"}
    gaps = {round(s, 6): n for n, s in b["idle_gaps"]}
    assert gaps == {0.5: "host op: aten::copy_",  # [4.5, 5.0]: the innermost op
                    1.5: "engine.predict_slide dense"}  # [6.0, 7.5]: no op, the span


def test_reduce_events_aligns_on_the_marker():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": MARK, "ts": 1_000_000.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1_500_000.0, "dur": 250_000.0},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 9_000_000.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1_100_000.0, "dur": 10.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1_200_000.0},
    ]
    tr = reduce_events(events, t_mark=100.0, t_a=100.0, t_b=101.0)
    assert tr.device == [(100.5, 100.75, "kernel", "k")]
    assert tr.host == [(pytest.approx(100.1), pytest.approx(100.10001), "aten::mm")]
    assert tr.busy_s() == pytest.approx(0.25)


def test_each_cell_reports_what_the_contract_asks():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        got = {m["name"] for m in metrics_for(bench, cell["name"], False)}
        assert "setup_s" in got and len(got) >= 2, cell["name"]
        pl = metrics_for(bench, cell["name"], True)
        assert pl and all(m["moves"] in got for m in pl), cell["name"]
        assert all(m["moves"] in e2e for m in pl)
        assert (BENCH / "checks" / f"{cell['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file() or (
            BENCH / "metrics" / f"{m['name'].split('.', 1)[0]}.py").is_file(), m["name"]
    assert math.isclose(sum(1 for w in bench["workloads"] if w["chips"] == 4), 0)
