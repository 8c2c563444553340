"""Tracing and profiling utilities, a port of ``deephisto_tpu/profiling.py``.

* ``trace(logdir)`` — a ``torch.profiler`` trace of the host and the card
  around any block, written into ``logdir`` as Chrome/Perfetto JSON,
* ``annotate(name)`` — a named region inside a trace (and an NVTX range on
  the card),
* ``StageTimer`` — per-stage wall-clock accounting with an items/s report,
  for the host-side loops a device trace does not cover.

A CUDA call returns before the card has finished its work, so
``StageTimer.stage`` takes an optional tensor (or a structure of them)
through ``sync=``: the stage then ends only once that tensor's device has
finished, and a scalar of it has been fetched.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the CPU and (where a card is
    present) CUDA activity around the enclosed block, written to
    ``<logdir>/trace.json`` as a Chrome trace, which Perfetto reads (so the
    JAX function's ``create_perfetto_trace`` has no counterpart). Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / TRACE_FILE))


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
