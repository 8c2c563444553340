"""device_idle_share (%, lower is better; layer: the device): 1 − the
union of the card's kernel, copy and memset intervals over the
sub-window's wall time (also read as ``device_idle_share.vit``)."""


def read(run):
    return None if run.trace is None else run.trace.idle_share()
