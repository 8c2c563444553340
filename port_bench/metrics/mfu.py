"""mfu (%, higher is better; layer: the model; also read as ``mfu.vit``):
the model operations that the slides served in the traced sub-window need
(each request's by the share of its service inside), counted from the
configuration's shapes, over the sub-window's seconds, as a share of the
H100's peak in the configuration's precision (int8 1,979 TOP/s, bf16 989
TFLOP/s)."""

from port_bench.core.record import model_share_of_peak


def read(run):
    return model_share_of_peak(run)
