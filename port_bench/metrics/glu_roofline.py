"""glu_roofline (%, higher is better; layer: kernels, ops/swiglu.py, K7):
Σ of the bound times of the SwiGLU gate calls that the sub-window's slides
need (each (N, 2·hidden) bf16 input read and (N, hidden) output written
once, at HBM bandwidth; ``families/vit_reg.py:glu_bound_s``) over the
device time of K7's kernels in the sub-window. A program without K7 gives
nothing."""

from port_bench.core.record import prorated

KERNEL_NAMES = ("swiglu_kernel",)  # csrc/swiglu.cu


def read(run):
    tr = run.trace
    if tr is None:
        return None
    device_s = tr.total_s("kernel", KERNEL_NAMES)
    bound_s = prorated(run.requests, "glu_bound_s", tr.t_a, tr.t_b)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
