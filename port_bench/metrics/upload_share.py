"""upload_share (%, lower is better; layer: slide ingest, the
host-to-card copies of predict/pipeline.py and predict/fcn.py):
host-to-device copy time in the trace over the sub-window's wall time
(also read as ``upload_share.vit``)."""


def read(run):
    return None if run.trace is None else run.trace.upload_share()
