"""setup_s (s, lower is better): from the process's start to the window's
start — imports, the card, the kernels' libraries (built on a checkout's
first run), weights, calibration, the host pool and the warm-up."""


def read(run):
    return run.setup_s
