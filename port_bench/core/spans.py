"""The program's own spans (``deephisto_tpu_torch.profiling.spans``) in the
traced sub-window, on the harness's clock (``time.perf_counter``), which the
device trace is aligned to. The one module of the harness that reads them.

A request is an ``engine.request`` span; it counts by the share of it that
lies in the sub-window, as ``record.prorated`` counts the harness's
requests. Every span but ``engine.request`` and ``engine.lock_wait`` runs
with the engine's lock held, so at any time at most one thread has such a
span open, and the innermost of them says what that thread is doing.

A program without spans, or a run without a trace, gives None throughout."""

from __future__ import annotations

from dataclasses import dataclass

REQUEST = "engine.request"
LOCK_WAIT = "engine.lock_wait"
HOST_WORK = ("predict.prepare", "predict.enqueue")
NO_REQUEST = "no request in the engine"


@dataclass
class Window:
    t_a: float
    t_b: float
    spans: list  # the program's spans that overlap [t_a, t_b], or whose request does

    def inside(self, s) -> float:
        """Seconds of ``s`` inside the sub-window."""
        return max(0.0, min(s.end, self.t_b) - max(s.start, self.t_a))

    def requests(self) -> dict:
        """request id → (share of its span in the sub-window, the span)."""
        return {s.request: (self.inside(s) / (s.end - s.start) if s.end > s.start else 1.0, s)
                for s in self.spans if s.name == REQUEST}

    def held(self) -> list:
        """The spans held under the engine's lock."""
        return [s for s in self.spans if s.name not in (REQUEST, LOCK_WAIT)]


def window(run) -> Window | None:
    """The spans that overlap the traced sub-window, with every span of a
    request that does; None where the run has no trace or the program
    records no spans."""
    try:
        from deephisto_tpu_torch.profiling import spans
    except ImportError:
        return None
    tr = run.trace
    if tr is None:
        return None
    recorded = spans()
    overlap = [s for s in recorded if s.end > tr.t_a and s.start < tr.t_b]
    reqs = {s.request for s in overlap if s.name == REQUEST}
    kept = [s for s in recorded if s.request in reqs or (s.end > tr.t_a and s.start < tr.t_b)]
    return Window(tr.t_a, tr.t_b, kept) if kept else None


def timeline(w: Window) -> list[tuple[float, float, str]]:
    """[t_a, t_b] cut where a span opens or closes, each piece named by the
    innermost span held under the engine's lock there (the one opened last;
    of two opened at once, the one that closes first, else the child), or
    :data:`NO_REQUEST`."""
    held = sorted(w.held(), key=lambda s: s.start)
    cuts = sorted({w.t_a, w.t_b} | {t for s in held for t in (s.start, s.end)
                                    if w.t_a < t < w.t_b})
    out, active, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(held) and held[i].start <= a:
            active.append(held[i])
            i += 1
        active = [s for s in active if s.end > a]
        covering = [s for s in active if s.end >= b]
        out.append((a, b, max(covering, key=_depth).name if covering else NO_REQUEST))
    return out


def _depth(s):
    return s.start, -s.end, s.id


def idle_split(run) -> dict[str, float] | None:
    """Seconds of the sub-window in which the card is idle
    (``Trace.idle_gaps``), by the innermost span held under the engine's
    lock (:func:`timeline`): they add up to the idle time."""
    w = window(run)
    if w is None:
        return None
    out: dict[str, float] = {}
    pieces = timeline(w)
    j = 0
    for ga, gb in run.trace.idle_gaps():
        while j < len(pieces) and pieces[j][1] <= ga:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < gb:
            a, b, name = pieces[k]
            d = min(b, gb) - max(a, ga)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out
