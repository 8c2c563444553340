"""The traced run's sub-window: ``torch.profiler`` (host operators and the
card's activity through CUPTI) over a few steady seconds in the middle of
the window, its Chrome trace written under ``TMPDIR``, read and deleted,
and reduced to what the per-layer metrics read: device intervals by kind
and name, host operators, and the window's edges on the harness's clock.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
MARK = "port_bench.mark"
TOP = 10  # entries of each list of the breakdown


@dataclass
class Trace:
    t_a: float  # the sub-window on the harness's clock (time.perf_counter)
    t_b: float
    device: list = field(default_factory=list)  # (start, end, cat, name), clipped
    host: list = field(default_factory=list)  # (start, end, name)
    spans: list = field(default_factory=list)  # the harness's own (start, end, name)
    counts: dict = field(default_factory=dict)  # complete events in the file, by category

    @property
    def window_s(self) -> float:
        return self.t_b - self.t_a

    def union(self, cats=DEVICE_CATS) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for a, b, cat, _ in sorted(self.device):
            if cat not in cats:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return sum(b - a for a, b in self.union(cats))

    def total_s(self, cat: str, name_has: tuple[str, ...] = ()) -> float:
        """Summed duration of the device events of ``cat`` whose lower-case
        name holds any of ``name_has`` (all of them when empty)."""
        return sum(b - a for a, b, c, n in self.device
                   if c == cat and (not name_has or any(s in n.lower() for s in name_has)))

    def idle_share(self) -> float | None:
        """% of the window in which no kernel, copy or memset ran."""
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def upload_share(self) -> float | None:
        """% of the window spent in host-to-device copies."""
        copies = sum(b - a for a, b, cat, name in self.device
                     if cat == "gpu_memcpy" and "htod" in name.lower())
        if self.window_s <= 0 or copies <= 0:
            return None
        return 100.0 * copies / self.window_s

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, t = [], self.t_a
        for a, b in self.union():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t_b > t:
            gaps.append((t, self.t_b))
        return gaps

    def host_doing(self, t: float) -> str:
        """The innermost traced host operator at ``t``, else the harness's
        own span there."""
        best = None
        for a, b, name in self.host:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        if best is not None:
            return "host op: " + best[2][:100]
        for a, b, name in self.spans:
            if a <= t <= b:
                return name
        return "host: no request in the engine"

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for a, b, _, name in self.device:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (b - a)
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {
            "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda x: -x[1])[:TOP]],
            "idle_gaps": [[self.host_doing((a + b) / 2), b - a] for a, b in gaps],
        }


class SubWindow:
    """Profiles ``length_s`` seconds from ``start_s`` after ``t0`` (the
    harness's clock). :meth:`run` blocks until the sub-window has closed;
    call it from the main thread while the traffic runs on others (the
    profiler's CUPTI client is registered from the main thread), then
    :meth:`finish` returns the reduced :class:`Trace`."""

    def __init__(self, t0: float, start_s: float, length_s: float):
        self.t0, self.start_s, self.length_s = t0, start_s, length_s

    def run(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        time.sleep(max(0.0, self.t0 + self.start_s - time.perf_counter()))
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with record_function(MARK):
            self.t_mark = time.perf_counter()
        self.t_a = time.perf_counter()
        time.sleep(self.length_s)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_b = time.perf_counter()
        self.prof.stop()

    def finish(self, spans) -> Trace:
        fd, path = tempfile.mkstemp(prefix="port_bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_events(events, self.t_mark, self.t_a, self.t_b, spans)


def reduce_events(events, t_mark: float, t_a: float, t_b: float, spans=()) -> Trace:
    """A Chrome trace's complete events → a :class:`Trace` on the harness's
    clock, aligned by the marker annotation recorded at ``t_mark``."""
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"]
    if not marks:
        raise RuntimeError("the trace holds no marker annotation")
    offset = float(marks[0]["ts"]) / 1e6 - t_mark
    tr = Trace(t_a, t_b, spans=list(spans))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) / 1e6 - offset
        b = a + float(e["dur"]) / 1e6
        cat = e.get("cat", "")
        tr.counts[cat] = tr.counts.get(cat, 0) + 1
        if cat in DEVICE_CATS:
            a, b = max(a, t_a), min(b, t_b)
            if b > a:
                tr.device.append((a, b, cat, str(e.get("name", ""))))
        elif cat in HOST_CATS and e.get("name") != MARK and b > t_a and a < t_b:
            tr.host.append((a, b, str(e.get("name", ""))))
    return tr
