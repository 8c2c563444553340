"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell,
its configuration file and its traffic; the traffic file names its kind
(``traffic/kinds/<kind>.py``), the configuration its family
(``families/<family>.py``), the cell its check (``checks/<cell>.json``),
and each metric has its reader (``metrics/<metric>.py``, or that of the
name before its first dot). A new configuration, traffic mix, cell or
metric is new files and entries; no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

from ..reference import FORBIDDEN_IMPORTS

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
JAX_SIDE = tuple(n for n in FORBIDDEN_IMPORTS if n != "deephisto_tpu_torch")


@dataclass
class Ctx:
    bench: dict
    cell: dict
    cfg: dict
    traffic: dict
    checks: dict
    seed: int
    device: torch.device
    family: ModuleType = field(repr=False, default=None)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def context(workload: str, seed: int, device, bench: dict | None = None) -> Ctx:
    """The cell's configuration, traffic and check, each from its own file."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    checks = load_json(BENCH_DIR / "checks" / f"{workload}.json")
    fam = importlib.import_module(f"port_bench.families.{cfg['family']}")
    return Ctx(bench, cell, cfg, traffic, checks, int(seed), torch.device(device), fam)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    those that list the cell, or list no cells and move an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moves)]


def reader(name: str) -> ModuleType:
    """The metric's reader, ``metrics/<name>.py``; where there is none, that
    of the name before its first dot (``mfu.vit`` is read as ``mfu``: a
    metric split by the end-to-end metric it moves, read alike)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} under {BENCH_DIR / 'metrics'}")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in JAX_SIDE})


def device_info(ctx: Ctx, peak: int) -> dict:
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": int(ctx.cell["chips"]), "memory_peak_bytes": int(peak)}


def run_cell(ctx: Ctx, seconds: float, trace: bool, t_start: float,
             control: bool = False) -> tuple[dict, dict, list]:
    """Set up, measure, free the program, judge. Returns (the result's
    line, the check's details, JAX modules found after the window)."""
    kind = importlib.import_module(f"port_bench.traffic.kinds.{ctx.traffic['kind']}").Kind(ctx)
    try:
        kind.setup()
        setup_s = time.perf_counter() - t_start
        run = kind.window(seconds, trace)
        run.setup_s = setup_s
        t_window = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
        found = jax_modules()
        kind.close()
        t_closed = time.perf_counter()
        check = kind.check(run, control)
        print(f"seconds: set-up {setup_s:.1f}, window and trace {t_window - t_start - setup_s:.1f}, "
              f"program freed {t_closed - t_window:.1f}, check {time.perf_counter() - t_closed:.1f}",
              file=sys.stderr)
    finally:
        kind.close()
    name = ctx.cell["name"]
    metrics = {}
    for m in metrics_for(ctx.bench, name, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": bool(check["correct"]),
        "attempted": len(run.requests),
        "failed": sum(1 for r in run.requests if not r.get("ok")),
        "metrics": metrics,
        "device": device_info(ctx, peak),
    }
    if trace:
        print(f"trace events by category: {run.trace.counts}", file=sys.stderr)
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = check["numbers"]
    return result, check, found
