"""engine_wait_share (%, lower is better; layer: engine, serve/engine.py):
the seconds the slide requests served in the traced sub-window waited for
the engine's lock (``engine.lock_wait``) over their seconds in the engine
(``engine.request``), each request by the share of it in the sub-window."""

from port_bench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    reqs = w.requests()
    waited = sum(reqs[s.request][0] * (s.end - s.start) for s in w.spans
                 if s.name == spans.LOCK_WAIT and s.request in reqs)
    total = sum(share * (s.end - s.start) for share, s in reqs.values())
    return 100.0 * waited / total if total > 0 else None
