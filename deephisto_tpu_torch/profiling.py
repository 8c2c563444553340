"""Tracing and profiling utilities, a port of ``deephisto_tpu/profiling.py``.

* ``trace(logdir)`` — a ``torch.profiler`` trace of the host and the card
  around any block, written into ``logdir`` as Chrome/Perfetto JSON,
* ``annotate(name)`` — a named region inside a trace (and an NVTX range on
  the card),
* ``StageTimer`` — per-stage wall-clock accounting with an items/s report,
  for the host-side loops a device trace does not cover,
* ``span(name, **attrs)`` — the program's own spans, recorded while a
  ``torch.profiler`` session runs anywhere in the process, read back with
  ``spans()``; ``blocking_copy`` is the host↔card copy inside one.

A profiler started on one thread records no ``record_function`` of a thread
that was running before it, so the serving engine's client threads keep
spans of their own: ``(name, start, end, thread, request, parent, id,
attrs)`` on ``time.perf_counter()``'s clock, parents from a thread-local
stack, kept in a bounded buffer. A span opened outside any other on its
thread starts a request: it draws a new request id, which every span under
it shares. With no profiler running a span reads one flag and records
nothing. ``trace`` writes the spans of its block into its ``trace.json``.

A CUDA call returns before the card has finished its work, so
``StageTimer.stage`` takes an optional tensor (or a structure of them)
through ``sync=``: the stage then ends only once that tensor's device has
finished, and a scalar of it has been fetched.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
TRACE_MARK = "deephisto.trace_mark"  # the annotation that aligns spans to the trace
MARKS = 3  # marker annotations at each end of a trace; the narrowest aligns
SPANS_KEPT = 1 << 16  # the newest spans the buffer holds


class Span(NamedTuple):
    """One finished span: ``start`` and ``end`` in seconds of
    ``time.perf_counter()``, the native id of the thread that recorded it,
    its request's id, the id of the span it opened under (None at a
    request's root) and its own id."""

    name: str
    start: float
    end: float
    thread: int
    request: int
    parent: int | None
    id: int
    attrs: dict


_spans: deque = deque(maxlen=SPANS_KEPT)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_open = threading.local()  # .stack: (span id, request id) of the thread's open spans


@contextlib.contextmanager
def span(name: str, **attrs):
    """A span of the program, recorded while a ``torch.profiler`` session
    runs in the process (``torch.autograd.profiler._is_profiler_enabled``,
    which every thread reads); otherwise the block only runs. Yields
    ``attrs``, which the block may add to."""
    if not _autograd_profiler._is_profiler_enabled:
        yield attrs
        return
    stack = _open.__dict__.setdefault("stack", [])
    parent, request = stack[-1] if stack else (None, next(_request_ids))
    sid = next(_span_ids)
    stack.append((sid, request))
    start = time.perf_counter()
    try:
        yield attrs
    finally:
        end = time.perf_counter()
        stack.pop()
        _spans.append(Span(name, start, end, threading.get_native_id(), request, parent, sid,
                           attrs))


def spans() -> list[Span]:
    """The finished spans the buffer holds, oldest first."""
    return list(_spans.copy())


def blocking_copy(t: torch.Tensor, device, name: str) -> torch.Tensor:
    """``t.to(device)`` in the span ``name``, attrs ``bytes``, ``pinned``
    (the source) and ``blocking``: a copy between the host and a card,
    which returns only once the host's side is done (a pageable upload
    first waits for the stream; a read-back, for the work it reads)."""
    if not _autograd_profiler._is_profiler_enabled:
        return t.to(device)
    crossing = t.device.type != torch.device(device).type
    with span(name, bytes=t.nbytes, pinned=t.is_pinned(), blocking=crossing):
        return t.to(device)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the CPU and (where a card is
    present) CUDA activity around the enclosed block, written to
    ``<logdir>/trace.json`` as a Chrome trace, which Perfetto reads (so the
    JAX function's ``create_perfetto_trace`` has no counterpart), with the
    program's spans of the block beside the profiler's events. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t_on = time.perf_counter()
    with profile(activities=activities) as prof:
        first = _marks()
        yield prof
        last = _marks()
    path = Path(logdir) / TRACE_FILE
    prof.export_chrome_trace(str(path))
    _write_spans(path, [s for s in spans() if s.start >= t_on], first, last)


def _marks() -> list[tuple[float, float]]:
    """MARKS marker annotations in a row, each as (width, middle) of the
    clock readings around it: a thread switch inside one widens it."""
    out = []
    for _ in range(MARKS):
        t0 = time.perf_counter()
        with torch.profiler.record_function(TRACE_MARK):
            t1 = time.perf_counter()
        out.append((t1 - t0, (t0 + t1) / 2))
    return out


def _write_spans(path: Path, recorded: list[Span], first: list, last: list) -> None:
    """Add ``recorded`` to the Chrome trace at ``path`` as complete events
    on their threads, moved to the trace's clock by the marker annotations
    taken at the block's start (``first``) and end (``last``): the narrowest
    of each anchors a line, as the two clocks may run at slightly different
    rates."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ts = sorted(float(e["ts"]) for e in events
                if e.get("name") == TRACE_MARK and e.get("ph") == "X")
    (_, t_a), ts_a = min(zip(first, ts[:MARKS]))
    (_, t_b), ts_b = min(zip(last, ts[-MARKS:]))
    rate = (ts_b - ts_a) / (t_b - t_a)  # trace µs per second of perf_counter
    pid = os.getpid()
    events.extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": ts_a + rate * (s.start - t_a), "dur": rate * (s.end - s.start),
         "args": {"request": s.request, "parent": s.parent, "id": s.id, **s.attrs}}
        for s in recorded
    )
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``torch.profiler.record_function`` in a trace, and an
    NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimer:
    """Accumulating per-stage wall-clock timer with items/s reporting."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.items: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _force_completion(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            line = f"{name}: {t:.3f}s over {self.counts[name]} calls"
            if self.items[name]:
                line += f" ({self.items[name] / t:,.0f} items/s)"
            lines.append(line)
        return "\n".join(lines)

    def print_report(self) -> None:
        print(self.report())


def _leaves(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _leaves(item)]
    return []


def _force_completion(x) -> None:
    """Ensure a device value has really finished computing: synchronize the
    first tensor's CUDA device, then fetch one scalar of it."""
    leaves = _leaves(x)
    if leaves:
        t = leaves[0]
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        if t.numel():
            t.reshape(-1)[0].item()
