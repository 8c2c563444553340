"""host_syncs_per_slide (count, lower is better; layer: predicts): the
blocking host-card transfers (spans with ``blocking`` set: the pageable
slide upload, the fcn scan's index uploads, the map's read-back) a slide
request makes, over the requests served in the traced sub-window, each by
the share of it in the sub-window."""

from port_bench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    reqs = w.requests()
    n = sum(reqs[s.request][0] for s in w.spans
            if s.attrs.get("blocking") and s.request in reqs)
    served = sum(share for share, _ in reqs.values())
    return n / served if served > 0 else None
