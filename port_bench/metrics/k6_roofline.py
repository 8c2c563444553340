"""k6_roofline (%, higher is better; layer: kernels, ops/conv_int8.py, K6):
Σ of the bound times of the int8 convs that the sub-window's slides need
(operations at the int8 peak or bytes at 3.35 TB/s, the larger, per conv
and 256-patch batch; the fcn mode's over the slide with no halo) over the
device time of K6's kernels in the sub-window."""

from port_bench.core.record import prorated

KERNEL_NAMES = ("conv_int8",)  # conv_int8_wgmma and conv_int8_mma (csrc/conv_int8.cu)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    device_s = tr.total_s("kernel", KERNEL_NAMES)
    bound_s = prorated(run.requests, "k6_bound_s", tr.t_a, tr.t_b)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
