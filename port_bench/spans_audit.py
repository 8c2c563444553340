"""The program's spans held against the device trace, in one traced window
of a ResNet cell on the card. From the checkout's root:

    python3 port_bench/spans_audit.py --workload r18q.dense.cohort --seed 1 --seconds 30

Prints one JSON object:

* ``metrics``: the four span metrics and ``device_idle_share``,
  ``upload_share`` of the same sub-window;
* ``idle_split_pct``: the sub-window's idle time by the innermost span held
  under the engine's lock (``core/spans.py:idle_split``), % of the window;
* ``pageable_htod_inside_pct``: % of the card's pageable host-to-card copy
  time that lies inside ``ingest.upload`` or ``xfer.h2d`` spans, also of the
  copies that start after the first recorded span (a copy under way when
  the profiler started has none);
* ``k1_after_enqueue``: of the requests wholly inside the sub-window, those
  whose first K1 kernel (after the previous request's read-back) starts
  after their ``predict.enqueue`` opens, and the least lead;
* ``syncs``: per such request, its blocking spans beside what the profiler
  saw inside its ``engine.serve`` span: pageable host-to-card and
  card-to-host copies, and synchronize calls; the calls found outside any
  blocking span, by the innermost span around them;
* ``timelines_ms``: for the first three such requests, their spans, the
  host's synchronize and copy calls and the card's copies, in ms from the
  request's ``engine.serve`` span;
* ``spans_per_request``, ``request_ms`` and ``span_us``: the recorder's
  cost, off and on (a loop of empty spans; ``nullcontext`` beside it).

Loads ``torch._inductor`` before the window, which the profiler's start
would otherwise load while the clients run. Sets nothing and gates
nothing."""

import argparse
import contextlib
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

K1 = "gather_quantize_int8"  # K1's int8 kernel (csrc/gather.cu)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
METRICS = ("engine_wait_share", "ingest_gbps", "idle_in_host_work_share",
           "host_syncs_per_slide", "device_idle_share", "upload_share")


# the profiler's host calls lie up to about 0.2 ms off the spans once
# aligned by the marker (more often after a span's end than before its
# start): a call within TOL of a span counts as inside it
TOL = 2e-4


def _within(a, b, s) -> bool:
    return s.start - TOL <= a and b <= s.end + TOL


def _copies(tr, a, b) -> dict:
    out = {"pageable_htod": 0, "dtoh": 0}
    for x, y, cat, name in tr.device:
        n = name.lower()
        if cat == "gpu_memcpy" and a <= x and y <= b:
            if "htod" in n and "pageable" in n:
                out["pageable_htod"] += 1
            elif "dtoh" in n:
                out["dtoh"] += 1
    return out


def audit(run) -> dict:
    from port_bench.core import spans
    from port_bench.core.harness import reader

    tr = run.trace
    w = spans.window(run)
    out = {"metrics": {n: reader(n).read(run) for n in METRICS}, "events": dict(tr.counts),
           "answered": sum(1 for q in run.requests if q.get("ok"))}
    if w is None:
        return out
    split = spans.idle_split(run)
    out["idle_split_pct"] = {k: 100.0 * v / tr.window_s for k, v in sorted(split.items())}
    out["idle_split_sum_pct"] = sum(out["idle_split_pct"].values())

    # a copy under way when the profiler started has no span: the spans of a
    # request begin once the recorder runs, so copies are also counted from
    # the first recorded span on
    ups = [s for s in w.spans if s.name in ("ingest.upload", "xfer.h2d")]
    t_on = min(s.start for s in w.spans)
    total = inside = total_on = inside_on = 0.0
    for a, b, cat, name in tr.device:
        n = name.lower()
        if cat == "gpu_memcpy" and "htod" in n and "pageable" in n:
            got = sum(max(0.0, min(b, s.end) - max(a, s.start)) for s in ups)
            total, inside = total + b - a, inside + got
            if a >= t_on:
                total_on, inside_on = total_on + b - a, inside_on + got
    out["pageable_htod_s"] = total
    out["pageable_htod_inside_pct"] = 100.0 * inside / total if total else None
    out["pageable_htod_inside_pct_from_first_span"] = (100.0 * inside_on / total_on
                                                       if total_on else None)

    by_req: dict = {}
    for s in w.spans:
        by_req.setdefault(s.request, []).append(s)
    reqs = sorted((s for s in w.spans if s.name == spans.REQUEST), key=lambda s: s.start)
    whole = [r for r in reqs if tr.t_a <= r.start and r.end <= tr.t_b]
    served = [s for s in w.spans if s.name == "engine.serve"]
    k1 = sorted(a for a, b, cat, name in tr.device if cat == "kernel" and K1 in name)
    leads, late, rows, stray, timelines, sync_ends = [], 0, [], {}, [], []
    for r in whole:
        own = by_req[r.request]
        serve = max((s for s in own if s.name == "engine.serve"), key=lambda s: s.start)
        enq = next(s for s in own if s.name == "predict.enqueue")
        # the card's work of the request served before this one ends by its
        # read-back, which the lock orders before this serve span
        before = [s.end for s in served if s.end <= serve.start]
        first = next((a for a in k1 if a >= max(before)), None) if before else None
        if first is not None:
            leads.append(first - enq.start)
            late += first >= enq.start
        if len(timelines) < 3:
            t0 = serve.start
            timelines.append(sorted(
                [(round(1e3 * (s.start - t0), 3), round(1e3 * (s.end - t0), 3), s.name)
                 for s in own]
                + [(round(1e3 * (a - t0), 3), round(1e3 * (b - t0), 3), "host " + name)
                   for a, b, name in tr.host if serve.start - 1e-3 <= a <= serve.end + 1e-3
                   and ("Synchronize" in name or "Memcpy" in name)]
                + [(round(1e3 * (a - t0), 3), round(1e3 * (b - t0), 3), "card " + name)
                   for a, b, cat, name in tr.device if cat == "gpu_memcpy"
                   and serve.start - 1e-3 <= a <= serve.end + 1e-3]))
        blocking = [s for s in own if s.attrs.get("blocking")]
        # the serve span's start stays strict: the request served before
        # this one synchronizes shortly before it
        calls = [(a, b, name) for a, b, name in tr.host
                 if name in SYNC_CALLS and serve.start <= a and b <= serve.end + TOL]
        for s in blocking:  # the copy's closing synchronize against the span's end
            ends = [b - s.end for a, b, name in calls if _within(a, b, s)]
            if ends:
                sync_ends.append(max(ends))
        for a, b, name in calls:
            if not any(_within(a, b, s) for s in blocking):
                around = [s for s in own if _within(a, b, s)]
                key = f"{name} in {max(around, key=lambda s: s.start).name}"
                stray[key] = stray.get(key, 0) + 1
        rows.append({"blocking": len(blocking), "syncs": len(calls),
                     **_copies(tr, serve.start, serve.end + TOL)})
    out["k1_after_enqueue"] = {"requests": len(leads), "after": int(late),
                               "least_lead_ms": 1e3 * min(leads) if leads else None}
    agree = sum(r["blocking"] == r["syncs"] == r["pageable_htod"] + r["dtoh"] for r in rows)
    patterns: dict = {}
    for row in rows:
        key = json.dumps(row, sort_keys=True)
        patterns[key] = patterns.get(key, 0) + 1
    out["syncs"] = {"requests": len(rows), "agree": agree, "stray_calls": stray,
                    "patterns": patterns}
    if sync_ends:
        q = statistics.quantiles(sync_ends, n=20) if len(sync_ends) > 1 else sync_ends * 19
        out["sync_end_after_span_end_us"] = {"min": 1e6 * min(sync_ends), "p5": 1e6 * q[0],
                                             "median": 1e6 * statistics.median(sync_ends),
                                             "p95": 1e6 * q[-1], "max": 1e6 * max(sync_ends)}
    out["timelines_ms"] = timelines
    out["spans_per_request"] = (statistics.mean(len(by_req[r.request]) for r in whole)
                                if whole else None)
    out["request_ms"] = 1e3 * statistics.mean(r.end - r.start for r in whole) if whole else None
    return out


def span_cost(n: int = 200_000) -> dict:
    """µs of an empty span, with the recorder off and on, and of an empty
    ``nullcontext`` block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deephisto_tpu_torch.profiling import span

    def loop(cm):
        t = time.perf_counter()
        for _ in range(n):
            with cm("audit"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"nullcontext": loop(lambda _: contextlib.nullcontext()), "off": loop(span)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on"] = loop(span)
    out["torch"] = torch.__version__
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()

    import torch

    from port_bench.core.harness import context

    if not torch.cuda.is_available():
        print("spans_audit: no CUDA card", file=sys.stderr)
        return 2
    # the profiler's start loads torch._inductor (torch.profiler's
    # prepare_trace asks hasattr(torch, "_inductor")); loaded during the
    # window, it competes with the clients for the interpreter lock for
    # seconds and delays the sub-window (PERF.md §7), so it is loaded here
    import torch._inductor.config  # noqa: F401

    ctx = context(args.workload, args.seed, "cuda:0")
    kind = importlib.import_module(f"port_bench.traffic.kinds.{ctx.traffic['kind']}").Kind(ctx)
    try:
        kind.setup()
        run = kind.window(args.seconds, True)
    finally:
        kind.close()
    out = {"workload": args.workload, "seed": args.seed, **audit(run), "span_us": span_cost()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
