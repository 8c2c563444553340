"""k3_roofline (%, higher is better; layer: kernels, ops/attention.py, K3):
Σ of the bound times of the attention calls that the sub-window's slides
need (4·B·H·N²·Dh operations at the bf16 peak, or q, k, v and the output
moved once, the larger) over the device time of K3's kernels in the
sub-window."""

from port_bench.core.record import prorated

KERNEL_NAMES = ("flash_fwd",)  # flash_fwd_tma and the other forwards (csrc/attention.cu)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    device_s = tr.total_s("kernel", KERNEL_NAMES)
    bound_s = prorated(run.requests, "k3_bound_s", tr.t_a, tr.t_b)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
