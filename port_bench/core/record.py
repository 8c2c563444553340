"""The record of one run that the metric readers read: the cell, its
configuration and traffic, the set-up time, every request with its times
and counts, and the traced sub-window."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .flops import PEAK_OPS
from .trace import Trace


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    setup_s: float = 0.0
    t0: float = 0.0  # the first request's submission
    t1: float = 0.0  # the last answer's return
    requests: list = field(default_factory=list)
    trace: Trace | None = None


def p95(values) -> float:
    """The 95th percentile by nearest rank: a value one of the requests
    took, with 5 % of the requests at or above it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def service_intervals(requests) -> list[tuple[float, float, dict]]:
    """(start, end, request) of each answered request with the card's work
    serialized: a request is served from its submission or from the previous
    answer, the later, to its own answer."""
    out, last = [], float("-inf")
    for r in sorted((r for r in requests if r.get("ok")), key=lambda r: r["t_done"]):
        start = max(r["t_submit"], last)
        out.append((start, r["t_done"], r))
        last = r["t_done"]
    return out


def prorated(requests, key: str, t_a: float, t_b: float) -> float:
    """Σ of ``key`` over the requests served in [t_a, t_b], each by the share
    of its service interval that lies inside."""
    total = 0.0
    for a, b, r in service_intervals(requests):
        inside = min(b, t_b) - max(a, t_a)
        if inside > 0 and b > a:
            total += r[key] * inside / (b - a)
    return total


def patches_per_s(run) -> float | None:
    """Equivalent patches of every answered slide over the seconds from the
    first submission to the last answer."""
    done = [r for r in run.requests if r.get("ok")]
    if not done or run.t1 <= run.t0:
        return None
    return sum(r["n_equiv"] for r in done) / (run.t1 - run.t0)


def model_share_of_peak(run) -> float | None:
    """% of the configuration's precision peak that the model operations of
    the slides served in the traced sub-window make over its seconds."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    work = prorated(run.requests, "work_ops", tr.t_a, tr.t_b)
    if work <= 0:
        return None
    return 100.0 * work / tr.window_s / PEAK_OPS[run.config["precision"]]
