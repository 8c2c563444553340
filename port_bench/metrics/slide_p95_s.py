"""slide_p95_s (s, lower is better): the 95th percentile, over every slide
request of the run, of the seconds from its submission to its map on the
host (a failed request at the time it failed)."""

from port_bench.core.record import p95


def read(run):
    if not run.requests:
        return None
    return p95([r["t_done"] - r["t_submit"] for r in run.requests])
