"""ingest_gbps (GB/s, higher is better; layer: slide ingest, the slide's
host-to-card copy in predict/pipeline.py and predict/fcn.py): the bytes of
the ``ingest.upload`` spans over their seconds on the host's clock, each
span by the share of it in the traced sub-window. A pageable copy's call
returns once its last chunk is staged for the card."""

from port_bench.core import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    ups = [s for s in w.spans if s.name == "ingest.upload" and s.end > s.start]
    seconds = sum(w.inside(s) for s in ups)
    moved = sum(s.attrs["bytes"] * w.inside(s) / (s.end - s.start) for s in ups)
    return moved / seconds / 1e9 if seconds > 0 else None
